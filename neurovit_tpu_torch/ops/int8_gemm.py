"""The int8 and bf16 GEMM probes (K17) and the int8 GEMM with the serving
epilogue (K18).

Counterparts of ``scripts/int8_pallas_bench.py``'s ``blocked_matmul``
(TPU kernel ``_mm_kernel`` :30) and ``dynquant_matmul`` (``_dq_kernel``
:55), which ``scripts/torch_int8_gemm_bench.py`` runs:

    blocked_matmul(a, b)              a [M, K], b [K, N], row-major:
        int8 x int8 -> int32 (exact), or bf16 x bf16 -> f32
    dynquant_matmul(a8, b8, sa, sb)   bf16((float(a8 . b8) * sa[m]) * sb[n])

The probes ask how near the card's int8 tensor-core rate the port's int8
path gets beside bf16 on the same tiling, and what the dequant epilogue
costs. The kernels (``csrc/int8_gemm.cu``) are hand-written Hopper GEMMs
on one mainloop (``csrc/hopper_gemm.cuh``): TMA loads of 128-byte K boxes
into a 4-stage shared-memory ring, ``wgmma`` from it, K tiled (the TPU
kernel keeps all of K resident), M, N and K multiples of 16. ``wgmma``
takes int8 operands only K-major, so each launch first transposes b [K, N]
into a scratch bT [N, K] that the wrapper allocates (``gemm_plan``).

The plain versions: the int8 product as an f64 matmul, exact here (|sum| <=
K * 127^2 < 2^53) and cast to int32 (torch has no integer matmul on CUDA);
bf16 as the f32 matmul of the (exact) f32 operands; K18 as the plain int8
product with the same epilogue, left to right. ``torch._int_mm``, a bf16
``torch.matmul`` and, where the install has it, ``torch.mm(...,
out_dtype=torch.float32)`` (K17 bf16's own output type) are the library
calls the bench times beside them, never the port's.

CPU tensors run the ``*_plain`` functions; CUDA tensors run the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neurovit_tpu_torch.ops.common import (INT, VOID, check_operand,
                                           check_smem, check_widths, launch,
                                           on_cpu, ptr)

DTYPES = (torch.int8, torch.bfloat16)
# The mainloop's ring (csrc/hopper_gemm.cuh, Mainloop): stages, bytes of K
# per stage of each operand row, and the slack that aligns the ring to the
# 128-byte swizzle's 1024 bytes.
STAGES, BOX_BYTES, ALIGN_SLACK = 4, 128, 1024


class GemmPlan(NamedTuple):
    """How one launch of K17/K18 covers [M, K] x [K, N]: a bm x bn output
    tile per block on a grid of (N tiles, M tiles), ``smem`` bytes of
    dynamic shared memory a block, and the shape of the transposed-B
    scratch the wrapper allocates."""
    bm: int
    bn: int
    grid: tuple
    smem: int
    scratch: tuple


def gemm_plan(m: int, n: int, k: int, dtype: torch.dtype) -> GemmPlan:
    """The kernel's plan for a [m, k] x [k, n] product of ``dtype``
    (int8 or bf16, the same plan): 128 x 128 tiles, or 64 x 64 where
    n <= 64 (a 128-row tile would leave most SMs idle at the attention PV
    shape). Raises where the kernel does not take the shape."""
    if dtype not in DTYPES:
        raise TypeError(f"the GEMM takes int8 or bf16, got {dtype}")
    check_widths("GEMM", M=m, N=n, K=k)
    tile = 64 if n <= 64 else 128
    smem = ALIGN_SLACK + STAGES * 2 * tile * BOX_BYTES + 2 * STAGES * 8
    check_smem("GEMM", smem)
    return GemmPlan(bm=tile, bn=tile, grid=(-(-n // tile), -(-m // tile)),
                    smem=smem, scratch=(n, k))


def blocked_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K17's function in plain PyTorch: int32 [M, N] for int8 operands,
    f32 for bf16."""
    if a.dtype == torch.int8:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.float(), b.float())


def dynquant_matmul_plain(a8: torch.Tensor, b8: torch.Tensor,
                          sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """K18's function in plain PyTorch: bf16((float(acc) * sa) * sb), sa
    [M, 1] (or [M]), sb [1, N] (or [N]) f32."""
    acc = blocked_matmul_plain(a8, b8).float()
    return ((acc * sa.reshape(-1, 1).float())
            * sb.reshape(1, -1).float()).to(torch.bfloat16)


def _check(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """Check a launch's operands; returns (M, N, K, bT): bT the [N, K]
    scratch the kernel transposes b into."""
    m, k = a.shape
    n = b.shape[1]
    check_operand("a", a, dtype)
    check_operand("b", b, dtype, (k, n))
    plan = gemm_plan(m, n, k, dtype)
    return m, n, k, torch.empty(plan.scratch, dtype=dtype, device=a.device)


def gemm_int8_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K17 on int8 operands: int32 [M, N]."""
    m, n, k, bt = _check(a, b, torch.int8)
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    launch("nvt_gemm_int8", (VOID,) * 4 + (INT,) * 3, a, ptr(a), ptr(b),
           ptr(bt), ptr(c), m, n, k)
    gemm_int8_cuda.launches += 1
    return c


gemm_int8_cuda.launches = 0


def gemm_bf16_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K17 on bf16 operands: f32 [M, N]."""
    m, n, k, bt = _check(a, b, torch.bfloat16)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    launch("nvt_gemm_bf16", (VOID,) * 4 + (INT,) * 3, a, ptr(a), ptr(b),
           ptr(bt), ptr(c), m, n, k)
    gemm_bf16_cuda.launches += 1
    return c


gemm_bf16_cuda.launches = 0


def dynquant_matmul_cuda(a8: torch.Tensor, b8: torch.Tensor,
                         sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K18."""
    m, n, k, bt = _check(a8, b8, torch.int8)
    sa = sa.reshape(-1).float().contiguous()
    sb = sb.reshape(-1).float().contiguous()
    check_operand("sa", sa, torch.float32, (m,))
    check_operand("sb", sb, torch.float32, (n,))
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a8.device)
    launch("nvt_gemm_int8_dequant", (VOID,) * 6 + (INT,) * 3, a8, ptr(a8),
           ptr(b8), ptr(bt), ptr(sa), ptr(sb), ptr(c), m, n, k)
    dynquant_matmul_cuda.launches += 1
    return c


dynquant_matmul_cuda.launches = 0


def blocked_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [K, N]: int32 for int8 operands, f32 for bf16. CPU
    tensors take the plain version, CUDA tensors the kernel's int8 or bf16
    instance."""
    if a.dtype not in DTYPES:
        raise TypeError(f"the GEMM takes int8 or bf16, got {a.dtype}")
    if on_cpu(a, b):
        return blocked_matmul_plain(a, b)
    return (gemm_int8_cuda if a.dtype == torch.int8 else gemm_bf16_cuda)(a, b)


def dynquant_matmul(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
                    sb: torch.Tensor) -> torch.Tensor:
    """bf16((float(a8 . b8) * sa[m]) * sb[n]). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    fn = (dynquant_matmul_plain if on_cpu(a8, b8, sa, sb)
          else dynquant_matmul_cuda)
    return fn(a8, b8, sa, sb)
