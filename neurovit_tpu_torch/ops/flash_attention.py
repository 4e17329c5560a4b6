"""Flash attention, forward and backward, in two layouts.

Counterpart of ``neurovit_tpu/ops/flash_attention.py``:

- ``layout="bnhd"`` ([B, N, H, D], the default): K1 and K5, the TPU kernels
  ``_fwd_kernel_allheads`` :233 and ``_bwd_kernel_allheads`` :269, what
  every fused block runs;
- ``layout="bhnd"`` ([B, H, N, D]): K6, the TPU kernels ``_fwd_kernel`` :91
  and ``_bwd_kernel`` :152, what ``ops.attention.sdpa`` runs for the
  Grad-CAM probe's block.

The two compute the same function. The softmax is the TPU kernel's, not
``F.softmax``: scores go to the exp2 domain, are clamped at +-96 in place
of the row-max subtraction (flash_attention.py:39-45), keys at or past
``n_valid`` are multiplied by 0, the denominator sums the f32
probabilities and the numerator takes them rounded to the input dtype,
with one divide at the end. Dropout on the probabilities (``dropout_rate``
> 0, training) multiplies the numerator's p by the Philox mask of element
(b, h, q, k) and the denominator by keep (flash_attention.py:258-262); the
mask is indexed by position, so both layouts draw the same bits.

The backward (:class:`FlashAttention`) regenerates P and the mask from q,
k, the forward's f32 row sums and the seed, and takes the row term delta
from the output: sum_k p m dp = keep * (dO . O). That is the TPU kernels'
sum(p * dp_m) (:313, and :207 for bhnd) computed through the rounded O,
because a GPU block does not hold a whole key row; the plain backward uses
the same formula.

CPU tensors run the ``*_plain`` functions; CUDA tensors run the kernels in
``csrc/flash_attention.cu`` (K1, K6) and ``csrc/flash_attention_bwd.cu``
(K5, K6's backward), each layout a template instance with its own launch
symbol and its own launch count.
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
LAYOUTS = ("bnhd", "bhnd")


def _to_bhnd(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A view of ``t`` in [B, H, N, D] (bnhd swaps axes 1 and 2)."""
    return t.permute(0, 2, 1, 3) if layout == "bnhd" else t


def _dims(q: torch.Tensor, layout: str):
    """(b, n, h, d) of a q in ``layout``."""
    b, a1, a2, d = q.shape
    return (b, a1, a2, d) if layout == "bnhd" else (b, a2, a1, d)


def _n_valid(q: torch.Tensor, n_valid: Optional[int],
             layout: str = "bnhd") -> int:
    n = _dims(q, layout)[1]
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


def _fwd_plain(q, k, v, *, scale, n_valid, dropout_rate, seed, layout):
    """The forward on tensors in ``layout``: o in the same layout and dtype
    as q, contiguous, and the f32 row sums [B, H, N]. Products of the
    (bf16) inputs are exact in f32, so the f32 matmuls stand for the
    kernel's bf16-in, f32-accumulate products."""
    n_valid = _n_valid(q, n_valid, layout)
    qf, kf, vf = (_to_bhnd(t, layout).float() for t in (q, k, v))
    p = _probs(qf, kf, scale, n_valid)
    denom = p.sum(dim=-1, keepdim=True)
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        p = p * nn.keep_mask(seed, p.shape, dropout_rate, q.device).float()
        o = torch.matmul(p.to(v.dtype).float(), vf) / (denom * keep)
    else:
        o = torch.matmul(p.to(v.dtype).float(), vf) / denom
    o = _to_bhnd(o.to(q.dtype), layout).contiguous()
    return o, denom[..., 0]


def _bwd_plain(q, k, v, o, do, lsum, *, scale, n_valid, dropout_rate, seed,
               layout):
    """The backward on tensors in ``layout``, step by step as the TPU
    kernels take it (flash_attention.py:289-323), with delta from the
    output as K5 and K6 take it. Returns dq, dk, dv in ``layout``."""
    dt = q.dtype
    qf, kf, vf, dof, of = (_to_bhnd(t, layout).float()
                           for t in (q, k, v, do, o))
    p = _probs(qf, kf, scale, n_valid) / lsum[..., None]
    keep = 1.0
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        mask = nn.keep_mask(seed, p.shape, dropout_rate, q.device).float()
    delta = keep * (dof * of).sum(-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_m = p * mask if dropout_rate else p
    dp_m = dp * mask if dropout_rate else dp
    ds = (p * (dp_m - delta[..., None]) * (scale / keep)).to(dt)
    dq = torch.matmul(ds.float(), kf).to(dt)
    dk = torch.matmul(ds.float().transpose(-1, -2), qf).to(dt)
    dv = (torch.matmul(p_m.to(dt).float().transpose(-1, -2), dof)
          * (1.0 / keep)).to(dt)
    return tuple(_to_bhnd(t, layout).contiguous() for t in (dq, dk, dv))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, n_valid: Optional[int] = None,
                          dropout_rate: float = 0.0, seed: int = 0,
                          return_stats: bool = False):
    """K1's function in plain PyTorch, same rounding points.
    q, k, v [B, N, H, D] -> o [B, N, H, D] in q's dtype (and, with
    ``return_stats``, the f32 row sums [B, H, N] the backward reads)."""
    o, lsum = _fwd_plain(q, k, v, scale=scale, n_valid=n_valid,
                         dropout_rate=dropout_rate, seed=seed, layout="bnhd")
    return (o, lsum) if return_stats else o


def flash_attention_bwd_plain(q, k, v, o, do, lsum, *, scale: float,
                              n_valid: int, dropout_rate: float = 0.0,
                              seed: int = 0):
    """K5's function in plain PyTorch. Returns dq, dk, dv [B, N, H, D]."""
    return _bwd_plain(q, k, v, o, do, lsum, scale=scale, n_valid=n_valid,
                      dropout_rate=dropout_rate, seed=seed, layout="bnhd")


def flash_attention_bhnd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               n_valid: Optional[int] = None,
                               dropout_rate: float = 0.0, seed: int = 0,
                               return_stats: bool = False):
    """K6's function in plain PyTorch: :func:`flash_attention_plain` on
    q, k, v [B, H, N, D] -> o [B, H, N, D]."""
    o, lsum = _fwd_plain(q, k, v, scale=scale, n_valid=n_valid,
                         dropout_rate=dropout_rate, seed=seed, layout="bhnd")
    return (o, lsum) if return_stats else o


def flash_attention_bhnd_bwd_plain(q, k, v, o, do, lsum, *, scale: float,
                                   n_valid: int, dropout_rate: float = 0.0,
                                   seed: int = 0):
    """K6's backward in plain PyTorch. Returns dq, dk, dv [B, H, N, D]."""
    return _bwd_plain(q, k, v, o, do, lsum, scale=scale, n_valid=n_valid,
                      dropout_rate=dropout_rate, seed=seed, layout="bhnd")


def _check_qkv(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, torch.bfloat16, q.shape)
    if q.shape[3] != 64:
        raise ValueError(f"the attention kernel takes head dim 64, got "
                         f"{q.shape[3]}")


def _fwd_cuda(symbol, layout, q, k, v, *, scale, n_valid, dropout_rate, seed,
              return_stats):
    _check_qkv(q, k, v)
    b, n, h, d = _dims(q, layout)
    n_valid = _n_valid(q, n_valid, layout)
    inv_keep, keep_q = dropout_args(dropout_rate)
    o = torch.empty_like(q)
    lsum = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
            if return_stats else None)
    launch(symbol, (VOID,) * 4 + (INT,) * 5 + (FLOAT, FLOAT, INT, U64, VOID),
           q, ptr(q), ptr(k), ptr(v), ptr(o), b, n, h, d, n_valid,
           float(scale * LOG2E), 1.0 / inv_keep, keep_q, int(seed), ptr(lsum))
    return (o, lsum) if return_stats else o


def _bwd_cuda(symbol, layout, q, k, v, o, do, lsum, *, scale, n_valid,
              dropout_rate, seed):
    _check_qkv(q, k, v)
    b, n, h, d = _dims(q, layout)
    check_operand("o", o, torch.bfloat16, q.shape)
    check_operand("do", do, torch.bfloat16, q.shape)
    check_operand("lsum", lsum, torch.float32, (b, h, n))
    inv_keep, keep_q = dropout_args(dropout_rate)
    keep = 1.0 / inv_keep
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    launch(symbol, (VOID,) * 10 + (INT,) * 5 + (FLOAT,) * 4 + (INT, U64), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lsum), ptr(delta),
           ptr(dq), ptr(dk), ptr(dv), b, n, h, d, int(n_valid),
           float(scale * LOG2E), float(scale / keep), keep, inv_keep, keep_q,
           int(seed))
    return dq, dk, dv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, n_valid: Optional[int] = None,
                         dropout_rate: float = 0.0, seed: int = 0,
                         return_stats: bool = False):
    """Launch the Hopper kernel K1: bf16 [B, N, H, 64], contiguous."""
    out = _fwd_cuda("nvt_flash_attention_fwd", "bnhd", q, k, v, scale=scale,
                    n_valid=n_valid, dropout_rate=dropout_rate, seed=seed,
                    return_stats=return_stats)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, do, lsum, *, scale: float,
                             n_valid: int, dropout_rate: float = 0.0,
                             seed: int = 0):
    """Launch the Hopper kernel K5 (two passes: dQ with delta, then dK and
    dV); returns dq, dk, dv [B, N, H, 64] bf16."""
    out = _bwd_cuda("nvt_flash_attention_bwd", "bnhd", q, k, v, o, do, lsum,
                    scale=scale, n_valid=n_valid, dropout_rate=dropout_rate,
                    seed=seed)
    flash_attention_bwd_cuda.launches += 1
    return out


flash_attention_bwd_cuda.launches = 0


def flash_attention_bhnd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              n_valid: Optional[int] = None,
                              dropout_rate: float = 0.0, seed: int = 0,
                              return_stats: bool = False):
    """Launch the Hopper kernel K6: bf16 [B, H, N, 64], contiguous, read and
    written in place (no transpose to bnhd)."""
    out = _fwd_cuda("nvt_flash_attention_bhnd_fwd", "bhnd", q, k, v,
                    scale=scale, n_valid=n_valid, dropout_rate=dropout_rate,
                    seed=seed, return_stats=return_stats)
    flash_attention_bhnd_cuda.launches += 1
    return out


flash_attention_bhnd_cuda.launches = 0


def flash_attention_bhnd_bwd_cuda(q, k, v, o, do, lsum, *, scale: float,
                                  n_valid: int, dropout_rate: float = 0.0,
                                  seed: int = 0):
    """Launch K6's backward (K5's two passes in the bhnd layout); returns
    dq, dk, dv [B, H, N, 64] bf16."""
    out = _bwd_cuda("nvt_flash_attention_bhnd_bwd", "bhnd", q, k, v, o, do,
                    lsum, scale=scale, n_valid=n_valid,
                    dropout_rate=dropout_rate, seed=seed)
    flash_attention_bhnd_bwd_cuda.launches += 1
    return out


flash_attention_bhnd_bwd_cuda.launches = 0

# layout -> ((plain forward, kernel forward), (plain backward, kernel
# backward)).
_IMPLS = {
    "bnhd": ((flash_attention_plain, flash_attention_cuda),
             (flash_attention_bwd_plain, flash_attention_bwd_cuda)),
    "bhnd": ((flash_attention_bhnd_plain, flash_attention_bhnd_cuda),
             (flash_attention_bhnd_bwd_plain, flash_attention_bhnd_bwd_cuda)),
}


class FlashAttention(torch.autograd.Function):
    """K1 forward and K5 backward (bnhd), or K6 forward and backward
    (bhnd). Residuals: q, k, v, the output and the f32 row sums (the output
    is the out-projection's input and is held anyway); the seed regenerates
    the mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid, dropout_rate, seed, layout):
        fwd = _IMPLS[layout][0][0 if on_cpu(q, k, v) else 1]
        o, lsum = fwd(q, k, v, scale=scale, n_valid=n_valid,
                      dropout_rate=dropout_rate, seed=seed, return_stats=True)
        ctx.save_for_backward(q, k, v, o, lsum)
        ctx.layout = layout
        ctx.args = dict(scale=scale, n_valid=n_valid,
                        dropout_rate=dropout_rate, seed=seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lsum = ctx.saved_tensors
        bwd = _IMPLS[ctx.layout][1][0 if on_cpu(q, do) else 1]
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lsum, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, n_valid: Optional[int] = None,
                    dropout_rate: float = 0.0, seed: int = 0,
                    layout: str = "bnhd") -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, N, H, D] (``layout="bnhd"``, K1
    and K5) or [B, H, N, D] (``"bhnd"``, K6), the output in the same
    layout; keys at or past ``n_valid`` (default N) get zero weight;
    probabilities dropped at ``dropout_rate`` with the site key ``seed``.
    Differentiable when an input requires grad. CPU tensors take the plain
    version, CUDA tensors the kernels."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n_valid = _n_valid(q, n_valid, layout)
    if is_training(q, k, v):
        return FlashAttention.apply(q, k, v, scale, n_valid,
                                    float(dropout_rate), int(seed), layout)
    fn = _IMPLS[layout][0][0 if on_cpu(q, k, v) else 1]
    return fn(q, k, v, scale=scale, n_valid=n_valid,
              dropout_rate=dropout_rate, seed=seed)
