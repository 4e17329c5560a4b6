"""Flash attention forward in the [B, N, H, D] (bnhd) layout.

Counterpart of ``neurovit_tpu/ops/flash_attention.py`` (forward of
``flash_attention(layout="bnhd")``; the TPU kernel is ``_fwd_kernel_allheads``,
:233). The softmax is the TPU kernel's, not ``F.softmax``: scores go to the
exp2 domain, are clamped at +-96 in place of the row-max subtraction
(flash_attention.py:39-45), keys at or past ``n_valid`` are multiplied by 0,
the denominator sums the f32 probabilities and the numerator takes them
rounded to the input dtype, with one divide at the end.

CPU tensors run :func:`flash_attention_plain`; CUDA tensors run the kernel
in ``csrc/flash_attention.cu`` through :func:`flash_attention_cuda`.
"""

from __future__ import annotations

from typing import Optional

import torch

from neurovit_tpu_torch.ops.common import (FLOAT, INT, VOID, check_operand,
                                           launch, on_cpu, ptr)

LOG2E = 1.4426950408889634
SCORE_CAP = 96.0


def _n_valid(q: torch.Tensor, n_valid: Optional[int]) -> int:
    n = q.shape[1]
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside [1, {n}]")
    return n_valid


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float,
                          n_valid: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, same rounding points.
    q, k, v [B, N, H, D] -> o [B, N, H, D] in q's dtype. Products of the
    (bf16) inputs are exact in f32, so the f32 matmuls stand for the
    kernel's bf16-in, f32-accumulate products."""
    n_valid = _n_valid(q, n_valid)
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(torch.clamp(s, -SCORE_CAP, SCORE_CAP))
    if n_valid < q.shape[1]:
        keep = (torch.arange(q.shape[1], device=q.device) < n_valid).float()
        p = p * keep
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vf) / denom
    return o.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         n_valid: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel: bf16 [B, N, H, 64], contiguous."""
    b, n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, torch.bfloat16, (b, n, h, d))
    if d != 64:
        raise ValueError(f"the attention kernel takes head dim 64, got {d}")
    n_valid = _n_valid(q, n_valid)
    o = torch.empty_like(q)
    launch("nvt_flash_attention_fwd",
           (VOID, VOID, VOID, VOID, INT, INT, INT, INT, INT, FLOAT), q,
           ptr(q), ptr(k), ptr(v), ptr(o), b, n, h, d, n_valid,
           float(scale * LOG2E))
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, n_valid: Optional[int] = None
                    ) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, N, H, D]; keys at or past
    ``n_valid`` (default N) get zero weight. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    fn = flash_attention_plain if on_cpu(q, k, v) else flash_attention_cuda
    return fn(q, k, v, scale=scale, n_valid=n_valid)
