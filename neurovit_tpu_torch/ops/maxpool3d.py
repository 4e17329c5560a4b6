"""The ResNet stem's 3-D max-pool (k=3, s=2, p=1) with argmax codes, and
its gradient gathered through the codes.

Counterpart of ``neurovit_tpu/ops/maxpool3d.py`` (TPU kernels
``_fwd_kernel`` :62 and ``_bwd_kernel`` :188, joined by the custom VJP of
``max_pool3d_pallas``), in JAX's layout at the public functions, NDHWC:

    max_pool3d_argmax(x)            x [B, D, H, W, C] -> (pooled, codes)
    max_pool3d_argmax_bwd(codes, g, x_shape, dtype) -> dx [B, D, H, W, C]

- the window is -inf padded; values are compared in f32 and stored in the
  input dtype;
- ``code = 9*kd + 3*kh + kw`` of the window's winner, in the TPU kernel's
  order: at each (kh, kw) tap the depth combine runs first, the lowest kd
  keeping a tie; the 9 taps then follow in row-major order with strict
  ``>``. This is neither torch's row-major ``return_indices`` nor XLA's
  split of a tie (ROADMAP.md, Queue 3, by design);
- codes are stored as ``uint8``: the same values as JAX's int32 codes, a
  quarter of the bytes;
- the backward is a gather: each input element sums, in f32, the g of the
  (at most 2x2x2) windows whose code points at it, in increasing code
  order, and is rounded once. No atomics, no scatter.

:class:`MaxPool3dArgmax` saves only the codes for the backward. CPU tensors
run the ``*_plain`` functions; CUDA tensors run ``csrc/maxpool3d.cu`` (K14
forward, K15 backward).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from neurovit_tpu_torch.ops.common import (INT, VOID, check_operand,
                                           is_training, launch, on_cpu, ptr)

KSIZE, STRIDE, PAD = 3, 2, 1
FLOAT_TYPES = (torch.bfloat16, torch.float32)


def out_dim(n: int) -> int:
    return (n + 2 * PAD - KSIZE) // STRIDE + 1


def _taps(n_out: int, k: int) -> slice:
    """Window offset ``k`` of every output along one padded axis: the
    padded positions 2o + k, o < n_out."""
    return slice(k, k + STRIDE * (n_out - 1) + 1, STRIDE)


def max_pool3d_argmax_plain(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (pooled in x's
    dtype, uint8 codes), both [B, OD, OH, OW, C]."""
    _, d, h, w, _ = x.shape
    od, oh, ow = out_dim(d), out_dim(h), out_dim(w)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1), value=float("-inf"))
    # Depth combine at every padded (h, w): the lowest kd keeps a tie.
    best = xp[:, _taps(od, 0)]
    kcode = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for kd in (1, 2):
        row = xp[:, _taps(od, kd)]
        kcode = torch.where(row > best, kd, kcode)
        best = torch.maximum(best, row)
    # The 9 (kh, kw) taps in row-major order, strict '>'.
    out = code = None
    for kh in range(KSIZE):
        for kw in range(KSIZE):
            tap = best[:, :, _taps(oh, kh), _taps(ow, kw)]
            tap_code = kcode[:, :, _taps(oh, kh), _taps(ow, kw)] * 9 + (
                3 * kh + kw)
            if out is None:
                out, code = tap, tap_code
            else:
                code = torch.where(tap > out, tap_code, code)
                out = torch.maximum(out, tap)
    return out.to(x.dtype), code.to(torch.uint8)


def max_pool3d_argmax_bwd_plain(codes: torch.Tensor, g: torch.Tensor,
                                x_shape: Sequence[int],
                                dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: each window's g
    goes to the input position its code names; each input position sums
    what it gets in f32, in increasing code order, rounded once."""
    b, d, h, w, c = x_shape
    od, oh, ow = codes.shape[1:4]
    gf = g.float()
    dxp = torch.zeros((b, d + 2, h + 2, w + 2, c), dtype=torch.float32,
                      device=g.device)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    for kd in range(KSIZE):
        for kh in range(KSIZE):
            for kw in range(KSIZE):
                k = 9 * kd + 3 * kh + kw
                dxp[:, _taps(od, kd), _taps(oh, kh), _taps(ow, kw)] += \
                    torch.where(codes == k, gf, zero)
    return dxp[:, 1:d + 1, 1:h + 1, 1:w + 1].to(dtype)


def _check_float(name: str, t: torch.Tensor) -> None:
    if t.dtype not in FLOAT_TYPES:
        raise TypeError(f"{name} must be bf16 or f32, got {t.dtype}")


def max_pool3d_argmax_cuda(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel K14 on NDHWC bf16 or f32 ``x``."""
    _check_float("x", x)
    check_operand("x", x, x.dtype)
    b, d, h, w, c = x.shape
    shape = (b, out_dim(d), out_dim(h), out_dim(w), c)
    out = x.new_empty(shape)
    codes = torch.empty(shape, dtype=torch.uint8, device=x.device)
    launch("nvt_maxpool3d_fwd", (VOID,) * 3 + (INT,) * 6, x, ptr(x),
           ptr(out), ptr(codes), b, d, h, w, c, int(x.dtype == torch.bfloat16))
    max_pool3d_argmax_cuda.launches += 1
    return out, codes


max_pool3d_argmax_cuda.launches = 0


def max_pool3d_argmax_bwd_cuda(codes: torch.Tensor, g: torch.Tensor,
                               x_shape: Sequence[int],
                               dtype: torch.dtype) -> torch.Tensor:
    """Launch the Hopper kernel K15: dx [B, D, H, W, C] in ``dtype``, which
    must be g's."""
    b, d, h, w, c = (int(n) for n in x_shape)
    _check_float("g", g)
    if g.dtype != dtype:
        raise TypeError(f"the pool's backward writes dx in g's dtype; got g "
                        f"{g.dtype} for dx {dtype}")
    shape = (b, out_dim(d), out_dim(h), out_dim(w), c)
    check_operand("g", g, g.dtype, shape)
    check_operand("codes", codes, torch.uint8, shape)
    dx = g.new_empty((b, d, h, w, c))
    launch("nvt_maxpool3d_bwd", (VOID,) * 3 + (INT,) * 6, g, ptr(codes),
           ptr(g), ptr(dx), b, d, h, w, c, int(g.dtype == torch.bfloat16))
    max_pool3d_argmax_bwd_cuda.launches += 1
    return dx


max_pool3d_argmax_bwd_cuda.launches = 0


def max_pool3d_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, uint8 codes) of NDHWC ``x``: the plain version for a CPU
    tensor, K14 for a CUDA tensor."""
    fn = max_pool3d_argmax_plain if on_cpu(x) else max_pool3d_argmax_cuda
    return fn(x)


def max_pool3d_argmax_bwd(codes: torch.Tensor, g: torch.Tensor,
                          x_shape: Sequence[int],
                          dtype: torch.dtype) -> torch.Tensor:
    """dx of the pool from its codes: the plain version for CPU tensors,
    K15 for CUDA tensors."""
    fn = (max_pool3d_argmax_bwd_plain if on_cpu(codes, g)
          else max_pool3d_argmax_bwd_cuda)
    return fn(codes, g, x_shape, dtype)


class MaxPool3dArgmax(torch.autograd.Function):
    """K14 forward, K15 backward; only the codes are kept between them."""

    @staticmethod
    def forward(ctx, x):
        out, codes = max_pool3d_argmax(x)
        ctx.save_for_backward(codes)
        ctx.x_shape, ctx.dtype = tuple(x.shape), x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (codes,) = ctx.saved_tensors
        return max_pool3d_argmax_bwd(codes, g.contiguous().to(ctx.dtype),
                                     ctx.x_shape, ctx.dtype)


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """``max_pool3d(x, 3, 2, 1)`` of NDHWC ``x`` (``max_pool3d_pallas``),
    differentiable through the codes when ``x`` requires grad."""
    if is_training(x):
        return MaxPool3dArgmax.apply(x)
    return max_pool3d_argmax(x)[0]
