"""Fused inverted dropout: the mask generated and applied in one pass (K16).

Counterpart of ``neurovit_tpu/ops/dropout.py`` (``dropout``; TPU kernel
``_mask_kernel`` :30, custom VJP :55-69), which the repo's probes run
(``scripts/dropout_bench.py``; here ``scripts/torch_dropout_bench.py``).
The model's own dropout sites are not this op: they keep ``nn.dropout``'s
q/256 keep, in and out of the fused block kernels.

This op keeps K16's quantization, not the q/256 one: an element is kept
where its 32-bit random word is below ``uint32(int(keep * (2^32 - 1)))``
(3865470565 at keep 0.9), and kept values are multiplied by ``1 / keep``
rounded to x's dtype (bf16: 1.109375 at keep 0.9), the two products
rounded to x's dtype as the Pallas body computes them:
``(x * mask) * s``.

The random words differ from the TPU's: the TPU kernel draws from the
core's PRNG seeded per 1024-row block (``pltpu.prng_random_bits``), which
no GPU reproduces. Here word(i) of the row-major element i is word
``i % 4`` of Philox4x32-10(counter = i // 4, key = seed) -- the generator
of ``nn.philox4x32`` and ``csrc/common.cuh`` -- so the mask is a function of
position: no layout padding, no dependence on the block size, and the
backward (:class:`Dropout`, the same kernel on the cotangent with the same
seed) regenerates it. Parity with JAX is statistical only, or exact on
words the test hands both sides.

The kernel is CUDA C++ (``csrc/dropout.cu``), not Triton: one elementwise
pass that the package's nvcc build and ctypes binding already serve, with
the Philox rounds shared with the block kernels' masks.

CPU tensors run :func:`dropout_plain`; CUDA tensors run the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, I64, INT, U32, U64, VOID,
                                           check_operand, is_training, launch,
                                           on_cpu, ptr)

FLOAT_TYPES = (torch.bfloat16, torch.float32)
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def keep_threshold32(rate: float) -> Tuple[int, float]:
    """(threshold, keep) of a rate: keep where the element's word is below
    ``threshold = uint32(int(keep * 4294967295.0))``, keep = 1 - rate
    (dropout.py:33)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - rate
    return int(keep * 4294967295.0) & _MASK32, keep


def scale_of(keep: float, dtype: torch.dtype) -> torch.Tensor:
    """1 / keep rounded to ``dtype``, the factor kept values are multiplied
    by (bf16: 1.109375 at keep 0.9)."""
    return torch.tensor(1.0 / keep, dtype=dtype)


def random_words(seed: int, numel: int, device=None) -> torch.Tensor:
    """The 32-bit words of elements 0 .. numel - 1: word i % 4 of
    Philox4x32-10(i // 4, seed), as int64 in [0, 2^32)."""
    counters = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    return nn.philox4x32(counters, int(seed) & _MASK64).reshape(-1)[:numel]


def apply_words(x: torch.Tensor, words: torch.Tensor,
                rate: float) -> torch.Tensor:
    """``(x * mask) * s`` in x's dtype, mask = words < the 32-bit threshold
    of ``rate``: the Pallas body (dropout.py:31-35) on given words, one per
    element of x in row-major order."""
    threshold, keep = keep_threshold32(rate)
    mask = (words.reshape(x.shape) < threshold).to(x.dtype)
    return (x * mask) * scale_of(keep, x.dtype).to(x.device)


def dropout_plain(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: :func:`apply_words` on the
    words of :func:`random_words`."""
    if rate == 0.0:
        return x
    return apply_words(x, random_words(seed, x.numel(), x.device), rate)


def dropout_cuda(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Launch the Hopper kernel K16 on a contiguous bf16 or f32 x of any
    shape."""
    threshold, keep = keep_threshold32(rate)
    if x.dtype not in FLOAT_TYPES:
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    check_operand("x", x, x.dtype)
    y = torch.empty_like(x)
    launch("nvt_dropout", (VOID, VOID, I64, INT, U32, FLOAT, U64), x,
           ptr(x), ptr(y), x.numel(),
           int(x.dtype == torch.float32), threshold,
           float(scale_of(keep, x.dtype)), int(seed) & _MASK64)
    dropout_cuda.launches += 1
    return y


dropout_cuda.launches = 0


def _apply(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    return (dropout_plain if on_cpu(x) else dropout_cuda)(x, rate, seed)


class Dropout(torch.autograd.Function):
    """K16 forward; the backward is K16 on the cotangent with the same seed
    (dropout.py:64-66): the same mask, the same scale."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _apply(x, rate, seed)

    @staticmethod
    def backward(ctx, g):
        return _apply(g.contiguous(), ctx.rate, ctx.seed), None, None


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of x at ``rate`` under the 64-bit key ``seed``; rate
    0 returns x. Differentiable when x requires grad. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if rate == 0.0:
        return x
    if is_training(x):
        return Dropout.apply(x, float(rate), int(seed))
    return _apply(x, float(rate), int(seed))
