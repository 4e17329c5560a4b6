"""Flash attention in the [B, N, H, D] (bnhd) layout, forward and backward.

Counterpart of ``neurovit_tpu/ops/flash_attention.py``
(``flash_attention(layout="bnhd")``; the TPU kernels are
``_fwd_kernel_allheads`` :233 and ``_bwd_kernel_allheads`` :269). The
softmax is the TPU kernel's, not ``F.softmax``: scores go to the exp2
domain, are clamped at +-96 in place of the row-max subtraction
(flash_attention.py:39-45), keys at or past ``n_valid`` are multiplied by 0,
the denominator sums the f32 probabilities and the numerator takes them
rounded to the input dtype, with one divide at the end. Dropout on the
probabilities (``dropout_rate`` > 0, training) multiplies the numerator's
p by the Philox mask of element (b, h, q, k) and the denominator by keep
(flash_attention.py:258-262).

The backward (:class:`FlashAttention`) regenerates P and the mask from q,
k, the forward's f32 row sums and the seed, and takes the row term delta
from the output: sum_k p m dp = keep * (dO . O). That is the TPU kernel's
sum(p * dp_m) (:313) computed through the bf16 O, because a GPU block does
not hold a whole key row; the plain backward uses the same formula.

CPU tensors run the ``*_plain`` functions; CUDA tensors run the kernels in
``csrc/flash_attention.cu`` (K1) and ``csrc/flash_attention_bwd.cu`` (K5).
"""

from __future__ import annotations

from typing import Optional

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, U64, VOID,
                                           check_operand, dropout_args,
                                           is_training, launch, on_cpu, ptr)

LOG2E = 1.4426950408889634
SCORE_CAP = 96.0


def _n_valid(q: torch.Tensor, n_valid: Optional[int]) -> int:
    n = q.shape[1]
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside [1, {n}]")
    return n_valid


def _probs(qf: torch.Tensor, kf: torch.Tensor, scale: float,
           n_valid: int) -> torch.Tensor:
    """exp2(clamp(q k^T * scale log2 e)) with keys past n_valid zeroed,
    [B, H, N, N] f32 (qf, kf in [B, H, N, D])."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(torch.clamp(s, -SCORE_CAP, SCORE_CAP))
    n = qf.shape[2]
    if n_valid < n:
        p = p * (torch.arange(n, device=qf.device) < n_valid).float()
    return p


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, n_valid: Optional[int] = None,
                          dropout_rate: float = 0.0, seed: int = 0,
                          return_stats: bool = False):
    """The kernel's function in plain PyTorch, same rounding points.
    q, k, v [B, N, H, D] -> o [B, N, H, D] in q's dtype (and, with
    ``return_stats``, the f32 row sums [B, H, N] the backward reads).
    Products of the (bf16) inputs are exact in f32, so the f32 matmuls
    stand for the kernel's bf16-in, f32-accumulate products."""
    n_valid = _n_valid(q, n_valid)
    qf, kf, vf = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    p = _probs(qf, kf, scale, n_valid)
    denom = p.sum(dim=-1, keepdim=True)
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        p = p * nn.keep_mask(seed, p.shape, dropout_rate, q.device).float()
        o = torch.matmul(p.to(v.dtype).float(), vf) / (denom * keep)
    else:
        o = torch.matmul(p.to(v.dtype).float(), vf) / denom
    o = o.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return (o, denom[..., 0]) if return_stats else o


def flash_attention_bwd_plain(q, k, v, o, do, lsum, *, scale: float,
                              n_valid: int, dropout_rate: float = 0.0,
                              seed: int = 0):
    """The backward kernel's function in plain PyTorch, step by step as
    the TPU kernel takes it (flash_attention.py:289-323), with delta from
    the output as K5 takes it. Returns dq, dk, dv [B, N, H, D]."""
    dt = q.dtype
    qf, kf, vf, dof = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, do))
    p = _probs(qf, kf, scale, n_valid) / lsum[..., None]
    keep = 1.0
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        mask = nn.keep_mask(seed, p.shape, dropout_rate, q.device).float()
    delta = keep * (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_m = p * mask if dropout_rate else p
    dp_m = dp * mask if dropout_rate else dp
    ds = (p * (dp_m - delta[..., None]) * (scale / keep)).to(dt)
    dq = torch.matmul(ds.float(), kf).to(dt)
    dk = torch.matmul(ds.float().transpose(-1, -2), qf).to(dt)
    dv = (torch.matmul(p_m.to(dt).float().transpose(-1, -2), dof)
          * (1.0 / keep)).to(dt)
    return tuple(t.permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))


def _check_qkv(q, k, v):
    b, n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, torch.bfloat16, (b, n, h, d))
    if d != 64:
        raise ValueError(f"the attention kernel takes head dim 64, got {d}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, n_valid: Optional[int] = None,
                         dropout_rate: float = 0.0, seed: int = 0,
                         return_stats: bool = False):
    """Launch the Hopper kernel K1: bf16 [B, N, H, 64], contiguous."""
    _check_qkv(q, k, v)
    b, n, h, d = q.shape
    n_valid = _n_valid(q, n_valid)
    inv_keep, keep_q = dropout_args(dropout_rate)
    o = torch.empty_like(q)
    lsum = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
            if return_stats else None)
    launch("nvt_flash_attention_fwd",
           (VOID,) * 4 + (INT,) * 5 + (FLOAT, FLOAT, INT, U64, VOID), q,
           ptr(q), ptr(k), ptr(v), ptr(o), b, n, h, d, n_valid,
           float(scale * LOG2E), 1.0 / inv_keep, keep_q, int(seed), ptr(lsum))
    flash_attention_cuda.launches += 1
    return (o, lsum) if return_stats else o


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, do, lsum, *, scale: float,
                             n_valid: int, dropout_rate: float = 0.0,
                             seed: int = 0):
    """Launch the Hopper kernel K5 (two passes: dQ with delta, then dK and
    dV); returns dq, dk, dv [B, N, H, 64] bf16."""
    _check_qkv(q, k, v)
    b, n, h, d = q.shape
    check_operand("o", o, torch.bfloat16, (b, n, h, d))
    check_operand("do", do, torch.bfloat16, (b, n, h, d))
    check_operand("lsum", lsum, torch.float32, (b, h, n))
    inv_keep, keep_q = dropout_args(dropout_rate)
    keep = 1.0 / inv_keep
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    launch("nvt_flash_attention_bwd",
           (VOID,) * 10 + (INT,) * 5 + (FLOAT,) * 4 + (INT, U64), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lsum), ptr(delta),
           ptr(dq), ptr(dk), ptr(dv), b, n, h, d, int(n_valid),
           float(scale * LOG2E), float(scale / keep), keep, inv_keep, keep_q,
           int(seed))
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward, K5 backward. Residuals: q, k, v, the output and the f32
    row sums (the output is the out-projection's input and is held
    anyway); the seed regenerates the mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid, dropout_rate, seed):
        fwd = flash_attention_plain if on_cpu(q, k, v) else flash_attention_cuda
        o, lsum = fwd(q, k, v, scale=scale, n_valid=n_valid,
                      dropout_rate=dropout_rate, seed=seed, return_stats=True)
        ctx.save_for_backward(q, k, v, o, lsum)
        ctx.args = dict(scale=scale, n_valid=n_valid,
                        dropout_rate=dropout_rate, seed=seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lsum = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if on_cpu(q, do)
               else flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lsum, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, n_valid: Optional[int] = None,
                    dropout_rate: float = 0.0, seed: int = 0
                    ) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, N, H, D]; keys at or past
    ``n_valid`` (default N) get zero weight; probabilities dropped at
    ``dropout_rate`` with the site key ``seed``. Differentiable when an
    input requires grad. CPU tensors take the plain version, CUDA tensors
    the kernels."""
    n_valid = _n_valid(q, n_valid)
    if is_training(q, k, v):
        return FlashAttention.apply(q, k, v, scale, n_valid,
                                    float(dropout_rate), int(seed))
    fn = flash_attention_plain if on_cpu(q, k, v) else flash_attention_cuda
    return fn(q, k, v, scale=scale, n_valid=n_valid,
              dropout_rate=dropout_rate, seed=seed)
