"""The 4D head: one post-LN temporal encoder layer and the projection.

Counterpart of ``neurovit_tpu/models/temporal.py`` (the reference's
``src/models/NeuroEncoder.py:207-230``): ``num_layers`` (1) post-LN layers,

    x = LN(x + drop(out_proj(MHSA(x))))
    x = LN(x + drop(linear2(drop(relu(linear1(x))))))

(temporal.py:61-86) with biased in- and out-projections, a ReLU FFN of
``dim_feedforward`` (2048), LayerNorm eps 1e-5, then ``Linear(d, d)``, the
projection head. In 4D the frozen ViT's 2-dim logits are this layer's input,
so d_model == num_classes == 2 and the head dim is 1 (SURVEY §2.1.7).

The layer is the port's own modules, not ``torch.nn.TransformerEncoderLayer``
(whose rounding points differ), under the reference's attribute names, so
its state-dict keys are ``temporal_transformer.transformer.layers.0.
self_attn.in_proj_weight`` and the rest (``neurovit_tpu/training/
state_dict.py:80-104``). It computes with ``nn``'s rounding points in the
activation dtype.

**The attention is not K1's function.** JAX reaches it through ``sdpa`` and,
for head dims below 8, the dense ``_sdpa_xla`` (attention.py:46-59,
flash_attention.py:517-537): f32 scores, the row-max softmax
(``torch.softmax``), probabilities rounded to the operand dtype before P·V,
and attention-probability dropout with the exact keep 1 - p and
``attn / keep``. :func:`attention` is that function in plain torch on every
device (no kernel takes head dim 1). Its dropout mask comes from the port's
Philox stream (:func:`keep_mask_exact`) under the layer's first site key;
the other three sites use ``nn.dropout``, the q/256 keep, as JAX's
``nn.dropout`` does. Site keys: ``nn.site_seed(seed, SITE + 4 l + j)`` for
layer l and site j in the order above.

Initialization as ``temporal.py:45-59``: xavier-uniform ``in_proj_weight``,
zero in- and out-projection biases, ``nn.Linear``'s default for the
out-projection weight, the FFN and the projection, LayerNorm ones / zeros.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn as tnn

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import _linear_init, _uniform_

# The temporal layers' dropout sites start here, past any ViT block's.
SITE = 1 << 16


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    d_model: int = 2
    nhead: int = 2
    dim_feedforward: int = 2048   # torch TransformerEncoderLayer default
    num_layers: int = 1           # NeuroEncoder.py:212
    dropout: float = 0.1          # torch default

    def __post_init__(self):
        if self.d_model % self.nhead:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"nhead {self.nhead}")


def keep_mask_exact(seed: int, shape, keep: float,
                    device=None) -> torch.Tensor:
    """Bool mask over ``shape`` kept with probability ``keep``: element i
    (row-major) is kept where word i % 4 of Philox4x32-10(i // 4, seed),
    a uniform 32-bit integer, is below keep * 2^32 (``jax.random.
    bernoulli``'s exact keep, not the q/256 of ``nn.keep_mask``)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    counters = torch.arange((numel + 3) // 4, dtype=torch.int64,
                            device=device)
    words = nn.philox4x32(counters, int(seed)).reshape(-1)[:numel]
    return (words < int(keep * 2.0 ** 32)).reshape(tuple(shape))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, dropout_rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """``_sdpa_xla`` over [B, H, T, D] (attention.py:46-59): f32 scores
    times ``scale``, the row-max softmax, dropout of the probabilities with
    the exact keep 1 - p (``attn / keep``), P rounded to q's dtype, P·V
    summed in f32 and rounded once. Differentiable through autograd."""
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(dots, dim=-1)
    if dropout_rate:
        keep = 1.0 - dropout_rate
        mask = keep_mask_exact(seed, attn.shape, keep, attn.device)
        attn = torch.where(mask, attn / keep, torch.zeros_like(attn))
    out = torch.matmul(attn.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


class MultiheadAttention(tnn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names:
    ``in_proj_weight`` [3d, d], ``in_proj_bias`` [3d], ``out_proj``."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.in_proj_weight = tnn.Parameter(torch.empty(3 * d, d,
                                                        device=device))
        self.in_proj_bias = tnn.Parameter(torch.empty(3 * d, device=device))
        self.out_proj = tnn.Linear(d, d, device=device)


class TemporalLayer(tnn.Module):
    """One post-LN encoder layer (temporal.py:61-86)."""

    def __init__(self, cfg: TemporalConfig, *, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.dim_feedforward
        self.nhead = cfg.nhead
        self.self_attn = MultiheadAttention(d, device=device)
        self.linear1 = tnn.Linear(d, ff, device=device)
        self.linear2 = tnn.Linear(ff, d, device=device)
        self.norm1 = tnn.LayerNorm(d, device=device)
        self.norm2 = tnn.LayerNorm(d, device=device)

    def forward(self, x: torch.Tensor, rate: float, seeds) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.nhead
        sa = self.self_attn
        qkv = nn.linear(x, sa.in_proj_weight, sa.in_proj_bias)
        qkv = qkv.reshape(b, t, 3, self.nhead, hd)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        a = attention(q, k, v, scale=hd ** -0.5, dropout_rate=rate,
                      seed=seeds[0])
        a = a.permute(0, 2, 1, 3).reshape(b, t, d)
        a = nn.linear(a, sa.out_proj.weight, sa.out_proj.bias)
        x = nn.layer_norm(x + nn.dropout(a, rate, seeds[1]),
                          self.norm1.weight, self.norm1.bias)
        h = torch.relu(nn.linear(x, self.linear1.weight, self.linear1.bias))
        h = nn.dropout(h, rate, seeds[2])
        h = nn.linear(h, self.linear2.weight, self.linear2.bias)
        return nn.layer_norm(x + nn.dropout(h, rate, seeds[3]),
                             self.norm2.weight, self.norm2.bias)


class _Stack(tnn.Module):
    def __init__(self, cfg: TemporalConfig, *, device=None):
        super().__init__()
        self.layers = tnn.ModuleList(TemporalLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers))


class TemporalTransformer(tnn.Module):
    """[B, T, d_model] -> [B, T, d_model]; the layers sit under
    ``transformer.layers`` as in the reference's ``nn.TransformerEncoder``."""

    def __init__(self, cfg: TemporalConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.transformer = _Stack(cfg, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """temporal.py:45-59, drawn from ``gen`` on the CPU."""
        d = self.cfg.d_model
        for layer in self.transformer.layers:
            sa = layer.self_attn
            _uniform_(sa.in_proj_weight, (6.0 / (d + 3 * d)) ** 0.5, gen)
            _linear_init(sa.out_proj, gen)
            _linear_init(layer.linear1, gen)
            _linear_init(layer.linear2, gen)
            with torch.no_grad():
                sa.in_proj_bias.zero_()
                sa.out_proj.bias.zero_()
            layer.norm1.reset_parameters()
            layer.norm2.reset_parameters()

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        """``rate`` > 0: dropout with the site keys of step ``seed``."""
        for i, layer in enumerate(self.transformer.layers):
            seeds = [nn.site_seed(seed, SITE + 4 * i + j) if rate else 0
                     for j in range(4)]
            x = layer(x, rate, seeds)
        return x


class ProjectionHead(tnn.Module):
    """``nn.Linear(d_in, d_out)`` under the reference's name
    (``projection_head.projection_head``, NeuroEncoder.py:219-230)."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.projection_head = tnn.Linear(d_in, d_out, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _linear_init(self.projection_head, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc = self.projection_head
        return nn.linear(x, fc.weight, fc.bias)
