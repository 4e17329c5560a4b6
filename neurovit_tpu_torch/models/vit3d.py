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
- ``quantize_blocks`` swaps every block for its int8 serving form
  (``Int8Attention``, ``Int8FeedForward``; vit3d.py:301-324, 379-384 and
  ``quantize_blocks``, int8_serving.py:84-106): the four GEMM weights
  become int8 per output channel, the f32 weights are dropped, and the
  blocks run the int8 ops (K10-K13; with ``int8_attn="off"``, K1 in place
  of K13). A quantized model is serving-only;
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

**The Grad-CAM probe** (``ViT3D.probe``; vit3d.py:251-288, 394-416,
509-554) stands in for the reference's hooks on the last block's attention
LayerNorm (``NeuroEncoder.py:70-82``): a ``probe_shift`` [B, N + 1, dim] is
added at that LayerNorm's output, and the gradient with respect to it is
the hook's gradient. Blocks 0..depth-2 take the fused path as in
``forward`` (without a graph unless the volume requires grad); the last
block takes JAX's unfused composition with JAX's rounding points:

- ``layer_norm`` (plain), then ``+ probe_shift`` in the compute dtype; the
  sum is the probe activation;
- q, k, v: the LN output times the dtype-cast QKV weight, each rounded once
  and laid out [B, H, N, D] contiguous;
- ``ops.attention.sdpa``, the bhnd flash attention (K6, forward and
  backward);
- the out-projection times the dtype-cast weight plus its f32 bias, rounded
  once; ``+ x``; then the fused MLP block (K4, and K9 in the backward).

The QKV and out-projection products are the einsums JAX leaves to XLA
outside any kernel: on the CPU an f32 sum of the exact products, as
``nn.linear``; on the card a cuBLAS product in the compute dtype (f32
accumulation), which rounds once before the out-projection's f32 bias is
added and once after (``_dense``). An int8-quantized model refuses the
probe, as JAX does (vit3d.py:401-404).

**Remat** (``ViTConfig.remat``, ``TRAINING_REMAT``; vit3d.py:513-529): in
a forward that autograd records with ``train=True``, blocks 0..depth-2 run
under ``torch.utils.checkpoint`` (non-reentrant), so they keep no
activations for the backward and run their forward again inside it; the
last block runs as is, as JAX's scan wraps only the scanned blocks in
``jax.checkpoint``. Each block's site keys are ints computed outside the
checkpointed function, so the recompute draws the same dropout bits and
there is no RNG state to preserve. The kernels' ``autograd.Function``s
keep only numbers on ``ctx`` besides ``save_for_backward``, so every tensor
they save is dropped and recomputed. Serving, the probe, eval and int8 run
unchanged.

**Tensor parallelism** (``parallel.tensor_parallel``): inside a
``parallel.use_mesh`` whose model axis is above 1 the model is a shard (H /
tp heads, mlp_dim / tp hidden columns) and ``Transformer`` runs each block
through ``tensor_parallel.tp_block``, the one-process blocks' kernels with
the row-parallel passes in their f32 partial forms and the model group's
collectives; outside one, the blocks run as above, bit for bit.

Not ported here: the pipeline path and the conv patch embed (see
``NeuroEncoder``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.attention import sdpa
from neurovit_tpu_torch.ops.flash_attention import flash_attention
from neurovit_tpu_torch.ops.fused_mlp import fused_mlp_block
from neurovit_tpu_torch.ops.fused_outproj import fused_outproj_residual
from neurovit_tpu_torch.ops.fused_qkv import fused_ln_qkv
from neurovit_tpu_torch.ops.int8_serving import (int8_flash_attention,
                                                 int8_ln_qkv, int8_mlp_block,
                                                 int8_outproj_residual,
                                                 quantize_weight)
from neurovit_tpu_torch.parallel.mesh import current_mesh

# The block widths the kernels are held to against their plain versions on
# the card (chip_smoke.py, tests/test_torch_cuda.py): name -> (dim, heads,
# dim_head, mlp_dim). The verify recipe's smoke model, head dims 32, 80
# (zero-padded to the 128 instance) and 128, the ViT-S/B/L widths (DeiT-S,
# ViT-B/16 and ViT-L/16) and the flagship.
WIDTHS = {
    "smoke": (64, 4, 16, 128),
    "hd32": (256, 8, 32, 512),
    "vit_s": (384, 6, 64, 1536),
    "vit_b": (768, 12, 64, 3072),
    "vit_l": (1024, 16, 64, 4096),
    "hd128": (1024, 8, 128, 2048),
    "hd80": (320, 4, 80, 640),
    "flagship": (1024, 8, 64, 2048),
}

SERVING_ONLY = "int8-quantized blocks are serving-only (train=False)"
PROBE_INT8 = ("the Grad-CAM probe needs the bf16 weights — int8-quantized "
              "params are serving-only")


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
    # int8 serving's attention: "pv" runs PV in int8 (K13), "off" the bf16
    # attention (K1) between the int8 QKV and out-projection.
    int8_attn: str = "pv"
    # Recompute blocks 0..depth-2 in the backward (training only).
    remat: bool = False

    def __post_init__(self):
        if self.image_size % self.image_patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        if self.frames % self.frame_patch_size:
            raise ValueError("Frames must be divisible by frame patch size")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {self.pool!r}")
        if self.int8_attn not in ("pv", "off"):
            raise ValueError(f"int8_attn must be 'pv' or 'off', got "
                             f"{self.int8_attn!r}")
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


def _dense(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T (+ b) in x's dtype for a torch-layout weight [out, in], a
    product JAX leaves to XLA. CPU: ``nn.linear`` (f32 sum of the exact
    products, f32 bias, one rounding). CUDA: one cuBLAS product in x's
    dtype with f32 accumulation, rounded, then the f32 bias added and
    rounded again."""
    if x.device.type == "cpu":
        return nn.linear(x, weight, bias)
    y = torch.matmul(x, weight.to(x.dtype).t())
    return y if bias is None else (y.float() + bias.float()).to(x.dtype)


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

    def forward_probe(self, x: torch.Tensor, probe_shift: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The probe's unfused block attention (vit3d.py:251-288, 410),
        deterministic: returns (x + to_out(attn(LN(x) + shift)), the probe
        activation LN(x) + shift), both in x's dtype."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        normed = nn.layer_norm(x, self.norm.weight, self.norm.bias)
        normed = normed + probe_shift.to(x.dtype)
        q, k, v = (_dense(normed, w).reshape(b, n, h, d).permute(0, 2, 1, 3)
                   .contiguous() for w in self.to_qkv.weight.chunk(3))
        o = sdpa(q, k, v, scale=d ** -0.5, n_valid=n)
        out = self.to_out[0]
        o = o.permute(0, 2, 1, 3).reshape(b, n, h * d)
        return _dense(o, out.weight, out.bias) + x, normed


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


def _buffers(module: tnn.Module, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        module.register_buffer(name, t.detach().clone())


class Int8Attention(tnn.Module):
    """int8 serving form of :class:`Attention`: x + int8 out-projection of
    the attention of the int8 QKV (vit3d.py:305-324). Holds the LN affine
    (f32), the int8 weights with their f32 scales and the f32 bias as
    buffers."""

    def __init__(self, attn: Attention, int8_attn: str):
        super().__init__()
        self.heads, self.dim_head = attn.heads, attn.dim_head
        self.int8_attn = int8_attn
        out = attn.to_out[0]
        qkv_w8, qkv_scale = quantize_weight(attn.to_qkv.weight)
        out_w8, out_scale = quantize_weight(out.weight)
        _buffers(self, norm_weight=attn.norm.weight.float(),
                 norm_bias=attn.norm.bias.float(), qkv_w8=qkv_w8,
                 qkv_scale=qkv_scale, out_w8=out_w8, out_scale=out_scale,
                 out_bias=out.bias.float())

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seeds: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        if rate:
            raise ValueError(SERVING_ONLY)
        b, n, _ = x.shape
        q, k, v = int8_ln_qkv(x, self.norm_weight, self.norm_bias,
                              self.qkv_w8, self.qkv_scale, self.heads,
                              self.dim_head)
        attend = flash_attention if self.int8_attn == "off" else \
            int8_flash_attention
        o = attend(q, k, v, scale=self.dim_head ** -0.5, n_valid=n)
        return int8_outproj_residual(x, o.reshape(b, n, -1), self.out_w8,
                                     self.out_scale, self.out_bias)


class Int8FeedForward(tnn.Module):
    """int8 serving form of :class:`FeedForward` (vit3d.py:379-384)."""

    def __init__(self, ff: FeedForward):
        super().__init__()
        norm, fc1, fc2 = ff.net[0], ff.net[1], ff.net[4]
        fc1_w8, fc1_scale = quantize_weight(fc1.weight)
        fc2_w8, fc2_scale = quantize_weight(fc2.weight)
        _buffers(self, norm_weight=norm.weight.float(),
                 norm_bias=norm.bias.float(), fc1_w8=fc1_w8,
                 fc1_scale=fc1_scale, fc1_bias=fc1.bias.float(),
                 fc2_w8=fc2_w8, fc2_scale=fc2_scale,
                 fc2_bias=fc2.bias.float())

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seeds: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        if rate:
            raise ValueError(SERVING_ONLY)
        return int8_mlp_block(x, self.norm_weight, self.norm_bias,
                              self.fc1_w8, self.fc1_scale, self.fc1_bias,
                              self.fc2_w8, self.fc2_scale, self.fc2_bias)


class Transformer(tnn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        self.layers = tnn.ModuleList(
            tnn.ModuleList([Attention(cfg, device=device, dtype=dtype),
                            FeedForward(cfg, device=device, dtype=dtype)])
            for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: int = 0, depth: Optional[int] = None,
                remat: bool = False) -> torch.Tensor:
        """``rate`` > 0: dropout with the site keys of step ``seed``.
        ``depth`` runs only the first ``depth`` blocks. ``remat``: every
        block but the stack's last runs under non-reentrant
        ``checkpoint``. Inside a ``parallel.use_mesh`` whose model axis is
        above 1 the blocks are this process's shard and run tensor-parallel
        over the mesh's model group (``parallel.tensor_parallel``)."""
        block = _block
        mesh = current_mesh()
        if mesh is not None and mesh.model > 1:
            from neurovit_tpu_torch.parallel import tensor_parallel as tp
            comm = tp.ProcessComm(mesh)

            def block(attn, ff, x, rate, s):
                return tp.tp_block([(attn, ff)], [x], comm, rate, s)[0]
        last = len(self.layers) - 1
        for i, (attn, ff) in enumerate(self.layers[:depth]):
            s = [nn.site_seed(seed, 1 + 4 * i + j) if rate else 0
                 for j in range(4)]
            if remat and i < last:
                x = checkpoint(block, attn, ff, x, rate, s,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(attn, ff, x, rate, s)
        return x


def _block(attn: tnn.Module, ff: tnn.Module, x: torch.Tensor, rate: float,
           s: Sequence[int]) -> torch.Tensor:
    """One block, attention then MLP, with its four site keys ``s``."""
    return ff(attn(x, rate, (s[0], s[1])), rate, (s[2], s[3]))


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

    @property
    def quantized(self) -> bool:
        """Whether the blocks are in their int8 serving form."""
        return isinstance(self.transformer.layers[0][0], Int8Attention)

    def _embed(self, volume: torch.Tensor) -> torch.Tensor:
        """Patch embedding, CLS token and positions: [B, N + 1, dim] in the
        volume's dtype."""
        cfg = self.cfg
        dt = volume.dtype
        pe = self.to_patch_embedding
        x = patchify(volume, cfg)
        x = nn.layer_norm(x, pe[1].weight, pe[1].bias)
        x = nn.linear(x, pe[2].weight, pe[2].bias)
        x = nn.layer_norm(x, pe[3].weight, pe[3].bias)
        b, n, _ = x.shape
        cls = self.cls_token.to(dt).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        return x + self.pos_embedding[:, :n + 1].to(dt)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=1) if self.cfg.pool == "mean" else x[:, 0]
        head_norm, head_fc = self.mlp_head
        pooled = nn.layer_norm(pooled, head_norm.weight, head_norm.bias)
        return nn.linear(pooled, head_fc.weight, head_fc.bias).float()

    def forward(self, volume: torch.Tensor, *, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        """``train=True`` applies dropout, keyed by the step's ``seed``.
        In f32 the products outside the kernels (patch embedding, head) run
        at full f32 (``nn.full_f32``)."""
        cfg = self.cfg
        if train and self.quantized:
            raise ValueError(SERVING_ONLY)
        if train and (cfg.dropout or cfg.emb_dropout) and seed is None:
            raise ValueError("dropout in training needs a seed")
        with nn.full_f32(volume.dtype):
            x = self._embed(volume)
            if train and cfg.emb_dropout:
                x = nn.dropout(x, cfg.emb_dropout, nn.site_seed(seed, 0))
            x = self.transformer(x, cfg.dropout if train else 0.0,
                                 seed if train and cfg.dropout else 0,
                                 remat=(train and cfg.remat
                                        and torch.is_grad_enabled()))
            return self._head(x)

    def probe(self, volume: torch.Tensor, probe_shift: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Grad-CAM probe forward (vit3d.py:419-554 with a
        ``probe_shift``), deterministic: (f32 logits [B, num_classes], the
        probe activation [B, N + 1, dim] in the volume's dtype).
        Differentiate the logits with respect to ``probe_shift`` for the
        hook gradients. Blocks 0..depth-2 record no graph unless the volume
        requires grad."""
        if self.quantized:
            raise ValueError(PROBE_INT8)
        depth = self.cfg.depth
        with nn.full_f32(volume.dtype):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and volume.requires_grad):
                x = self.transformer(self._embed(volume), depth=depth - 1)
            attn, ff = self.transformer.layers[depth - 1]
            x, probe_act = attn.forward_probe(x, probe_shift)
            return self._head(ff(x)), probe_act


@torch.no_grad()
def quantize_blocks(vit: ViT3D) -> ViT3D:
    """Swap every block of ``vit`` for its int8 serving form, in place, and
    return it (``quantize_blocks``, int8_serving.py:84-106): the qkv,
    out-projection, fc1 and fc2 weights are quantized from their f32
    masters and dropped; LN affines and biases stay f32. Patch embedding
    and head are unchanged."""
    if vit.quantized:
        raise ValueError("the blocks are already quantized")
    for pair in vit.transformer.layers:
        pair[0] = Int8Attention(pair[0], vit.cfg.int8_attn)
        pair[1] = Int8FeedForward(pair[1])
    return vit
