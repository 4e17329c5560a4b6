"""Functional forward primitives, with the JAX package's rounding points.

Counterpart of ``neurovit_tpu/nn.py:62-85``. Parameters live in
``torch.nn`` modules (``nn.LayerNorm``, ``nn.Linear``) as f32 master
weights; these functions compute with them in the activation dtype the way
the JAX package does, which is not what ``F.layer_norm`` and ``F.linear``
do in bf16:

- ``layer_norm``: statistics and affine in f32, one rounding at the end;
- ``linear``: an f32 sum of the (dtype-rounded) products plus an f32 bias,
  rounded once;
- ``gelu``: exact erf GELU.

Dropout is left out: the port serves, and serving is deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-5  # torch nn.LayerNorm default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last dim, computed in f32, returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T (+ b) for a torch-layout weight [out, in]. The weight is
    rounded to x's dtype, the products summed in f32 (exact for bf16
    operands), the bias added in f32, and the result rounded once."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x, approximate="none")
