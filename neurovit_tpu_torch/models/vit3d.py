"""3D Vision Transformer on the fused kernels, for serving and training.

Counterpart of ``neurovit_tpu/models/vit3d.py`` (reference semantics of
``src/models/vit_3d.py``):

- ``patchify`` keeps the (p1 p2 pf c) order inside each patch vector
  (vit3d.py:159-173), so patch-embedding weights interchange;
- the gather patch embed LN -> Linear -> LN (vit3d.py:176-182);
- the CLS token and the pos-embedding over num_patches + 1 tokens;
- ``depth`` pre-norm blocks, each through the four fused ops
  (vit3d.py:325-391): LN+QKV, flash attention in the [B, N, H, D] layout,
  out-projection + residual, MLP block;
- cls/mean pooling, then LN + Linear (vit3d.py:498-506);
- ``train=True`` turns dropout on (``dropout``, ``emb_dropout``): on the
  embedding (vit3d.py:441, plain, outside any kernel) and, per block,
  inside the kernels on the attention probabilities, the out-projection,
  the MLP hidden and the MLP output. Every site gets its own Philox key,
  ``nn.site_seed(seed, site)`` of the step's ``seed``: site 0 is the
  embedding, block i uses sites 1 + 4i .. 4 + 4i in that order.

The token stream is the real length (1001 at the flagship shape), not the
TPU's lane-padded 1024 (vit3d.py:444-457): the attention kernel masks its
own ragged edge. Module attribute names follow the reference's torch keys
(``neurovit_tpu/training/state_dict.py:35-77``), so ``state_dict()`` keys are
the checkpoint keys. Param-less slots of the reference's ``nn.Sequential``s
(the patch rearrange, GELU, dropouts) are ``nn.Identity`` placeholders that
keep the indices; the forward never calls the ``Sequential``s.

The weights are cast to the activation dtype outside the fused ops, so in
bf16 the ops' weight gradients are bf16 and autograd upcasts them to the
f32 master weights, as JAX's ``kernel.astype(x.dtype)`` does
(fused_mlp.py:330-333). LayerNorm affines and biases enter as f32.

Not ported here: the pipeline path, the Grad-CAM probe, the int8 branch,
the conv patch embed and remat (see ``NeuroEncoder``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn as tnn

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.flash_attention import flash_attention
from neurovit_tpu_torch.ops.fused_mlp import fused_mlp_block
from neurovit_tpu_torch.ops.fused_outproj import fused_outproj_residual
from neurovit_tpu_torch.ops.fused_qkv import fused_ln_qkv


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int            # H == W
    image_patch_size: int
    frames: int                # depth axis
    frame_patch_size: int
    num_classes: int
    dim: int = 1024
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 2048
    channels: int = 1
    pool: str = "cls"          # 'cls' or 'mean'
    dropout: float = 0.0       # in the blocks, when training
    emb_dropout: float = 0.0   # on the embedding, when training

    def __post_init__(self):
        if self.image_size % self.image_patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        if self.frames % self.frame_patch_size:
            raise ValueError("Frames must be divisible by frame patch size")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {self.pool!r}")
        if self.heads == 1 and self.dim_head == self.dim:
            # vit_3d.py:32: the reference drops the out-projection here; the
            # fused out-projection kernel has no identity form.
            raise NotImplementedError(
                "an identity out-projection (heads == 1, dim_head == dim) "
                "is not ported")

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.frames // self.frame_patch_size,
                self.image_size // self.image_patch_size,
                self.image_size // self.image_patch_size)

    @property
    def num_patches(self) -> int:
        f, h, w = self.grid
        return f * h * w

    @property
    def patch_dim(self) -> int:
        return self.channels * self.image_patch_size ** 2 * self.frame_patch_size

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


def patchify(volume: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, (f h w), (p1 p2 pf c)], the einops pattern
    'b c (f pf) (h p1) (w p2) -> b (f h w) (p1 p2 pf c)'."""
    b = volume.shape[0]
    f, h, w = cfg.grid
    pf, p = cfg.frame_patch_size, cfg.image_patch_size
    c = cfg.channels
    x = volume.reshape(b, c, f, pf, h, p, w, p)
    #          b  c  f  pf h  p1 w  p2 -> b f h w p1 p2 pf c
    x = x.permute(0, 2, 4, 6, 5, 7, 3, 1)
    return x.reshape(b, f * h * w, p * p * pf * c)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    """Draw on the generator's device (the CPU), copy to ``t``'s: the same
    seed gives the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape, dtype=t.dtype).uniform_(
            -bound, bound, generator=gen))


def _linear_init(layer: tnn.Linear, gen: torch.Generator) -> None:
    """torch nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    the weight and the bias (neurovit_tpu/nn.py:39-51)."""
    bound = 1.0 / layer.in_features ** 0.5
    _uniform_(layer.weight, bound, gen)
    if layer.bias is not None:
        _uniform_(layer.bias, bound, gen)


class Attention(tnn.Module):
    """Pre-norm MHSA with its residual: x + to_out(attn(LN(x)))."""

    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.heads, self.dim_head = cfg.heads, cfg.dim_head
        self.norm = tnn.LayerNorm(cfg.dim, **fk)
        self.to_qkv = tnn.Linear(cfg.dim, 3 * cfg.inner_dim, bias=False, **fk)
        # [1] is the reference's Dropout slot.
        self.to_out = tnn.Sequential(tnn.Linear(cfg.inner_dim, cfg.dim, **fk),
                                     tnn.Identity())

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seeds: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        """``seeds``: the keys of the probability and projection sites."""
        b, n, _ = x.shape
        dt = x.dtype
        q, k, v = fused_ln_qkv(x, self.norm.weight, self.norm.bias,
                               self.to_qkv.weight.to(dt), self.heads,
                               self.dim_head)
        o = flash_attention(q, k, v, scale=self.dim_head ** -0.5, n_valid=n,
                            dropout_rate=rate, seed=seeds[0])
        out = self.to_out[0]
        return fused_outproj_residual(x, o.reshape(b, n, -1),
                                      out.weight.to(dt), out.bias,
                                      dropout_rate=rate, seed=seeds[1])


class FeedForward(tnn.Module):
    """Pre-norm MLP with its residual: x + fc2(GELU(fc1(LN(x))))."""

    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        # Slots 2, 3 and 5 are the reference's GELU and Dropouts.
        self.net = tnn.Sequential(
            tnn.LayerNorm(cfg.dim, **fk),
            tnn.Linear(cfg.dim, cfg.mlp_dim, **fk), tnn.Identity(),
            tnn.Identity(), tnn.Linear(cfg.mlp_dim, cfg.dim, **fk),
            tnn.Identity())

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seeds: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        """``seeds``: the keys of the hidden and output sites."""
        norm, fc1, fc2 = self.net[0], self.net[1], self.net[4]
        dt = x.dtype
        return fused_mlp_block(x, norm.weight, norm.bias, fc1.weight.to(dt),
                               fc1.bias, fc2.weight.to(dt), fc2.bias,
                               dropout_rate=rate, seeds=seeds)


class Transformer(tnn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        self.layers = tnn.ModuleList(
            tnn.ModuleList([Attention(cfg, device=device, dtype=dtype),
                            FeedForward(cfg, device=device, dtype=dtype)])
            for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        """``rate`` > 0: dropout with the site keys of step ``seed``."""
        for i, (attn, ff) in enumerate(self.layers):
            s = [nn.site_seed(seed, 1 + 4 * i + j) if rate else 0
                 for j in range(4)]
            x = ff(attn(x, rate, (s[0], s[1])), rate, (s[2], s[3]))
        return x


class ViT3D(tnn.Module):
    """[B, C, F, H, W] volume -> f32 logits [B, num_classes]. Computes in
    the volume's dtype (bf16 on the serving path); parameters are f32."""

    def __init__(self, cfg: ViTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        fk = {"device": device, "dtype": dtype}
        # [0] is the reference's Rearrange (``patchify`` here).
        self.to_patch_embedding = tnn.Sequential(
            tnn.Identity(), tnn.LayerNorm(cfg.patch_dim, **fk),
            tnn.Linear(cfg.patch_dim, cfg.dim, **fk), tnn.LayerNorm(cfg.dim, **fk))
        self.pos_embedding = tnn.Parameter(
            torch.empty(1, cfg.num_patches + 1, cfg.dim, **fk))
        self.cls_token = tnn.Parameter(torch.empty(1, 1, cfg.dim, **fk))
        self.transformer = Transformer(cfg, **fk)
        self.mlp_head = tnn.Sequential(tnn.LayerNorm(cfg.dim, **fk),
                                       tnn.Linear(cfg.dim, cfg.num_classes, **fk))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """PyTorch-default distributions (neurovit_tpu/models/vit3d.py:107-141):
        Linear uniform, LayerNorm ones/zeros, pos/CLS standard normal."""
        for module in self.modules():
            if isinstance(module, tnn.Linear):
                _linear_init(module, gen)
            elif isinstance(module, tnn.LayerNorm):
                module.reset_parameters()
        with torch.no_grad():
            for p in (self.pos_embedding, self.cls_token):
                p.copy_(torch.randn(p.shape, dtype=p.dtype, generator=gen))

    def forward(self, volume: torch.Tensor, *, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        """``train=True`` applies dropout, keyed by the step's ``seed``."""
        cfg = self.cfg
        if train and (cfg.dropout or cfg.emb_dropout) and seed is None:
            raise ValueError("dropout in training needs a seed")
        dt = volume.dtype
        pe = self.to_patch_embedding
        x = patchify(volume, cfg)
        x = nn.layer_norm(x, pe[1].weight, pe[1].bias)
        x = nn.linear(x, pe[2].weight, pe[2].bias)
        x = nn.layer_norm(x, pe[3].weight, pe[3].bias)

        b, n, _ = x.shape
        cls = self.cls_token.to(dt).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding[:, :n + 1].to(dt)
        if train and cfg.emb_dropout:
            x = nn.dropout(x, cfg.emb_dropout, nn.site_seed(seed, 0))
        x = self.transformer(x, cfg.dropout if train else 0.0,
                             seed if train and cfg.dropout else 0)

        pooled = x.mean(dim=1) if cfg.pool == "mean" else x[:, 0]
        head_norm, head_fc = self.mlp_head
        pooled = nn.layer_norm(pooled, head_norm.weight, head_norm.bias)
        return nn.linear(pooled, head_fc.weight, head_fc.bias).float()
