"""Scaled-dot-product multi-head attention over [B, H, N, D].

Counterpart of ``neurovit_tpu/ops/attention.py``. ``sdpa`` is the
flash-attention path in the bhnd layout (K6, ``flash_attention(...,
layout="bhnd")``): what JAX's ``sdpa(impl="pallas")`` runs for the Grad-CAM
probe's block (vit3d.py:275-277). The port has no ``impl`` switch: CPU
tensors take K6's plain version, CUDA tensors the kernel.

``_sdpa_xla`` is JAX's ``xla`` impl without dropout: the dense
softmax(q k^T * scale) v with the row-max softmax, materializing the
[B, H, N, N] probabilities. No path of the port runs it; the tests hold
``sdpa``'s exp2 softmax clamped at +-96 against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from neurovit_tpu_torch.ops.flash_attention import flash_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
         n_valid: Optional[int] = None, dropout_rate: float = 0.0,
         seed: int = 0) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, N, D], keys at or past
    ``n_valid`` masked, probabilities dropped at ``dropout_rate`` with the
    site key ``seed``. Differentiable when an input requires grad."""
    return flash_attention(q, k, v, scale=scale, n_valid=n_valid,
                           dropout_rate=dropout_rate, seed=seed,
                           layout="bhnd")


def _sdpa_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float) -> torch.Tensor:
    """The dense reference (attention.py:46-59, deterministic): f32 scores,
    ``torch.softmax``, probabilities rounded to q's dtype before PV, the
    output rounded once."""
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(dots, dim=-1)
    out = torch.matmul(attn.to(q.dtype).float(), v.float())
    return out.to(q.dtype)
