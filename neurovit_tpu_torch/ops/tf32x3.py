"""The weight pre-passes of the f32 GEMMs that run in 3xTF32 on ``wgmma``
(``csrc/tf32x3_wgmma.cuh``: K4 and K9 at f32, ``ops/fused_mlp.py``; K2 and
K7 at f32, ``ops/fused_qkv.py``; K3 and K8 at f32,
``ops/fused_outproj.py``), and the plan of those GEMMs' launches.

``wgmma`` takes TF32 operands K-major only. Each call first writes its
weight split for 3xTF32: big = W rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero: ``cvt.rna.tf32.f32``) and small = W - big,
which is exact, so big + small == W bit for bit. A torch Linear weight W
[out, in] is K-major for the forwards' products (u . W1^T, g . W2^T, u .
Wqkv^T, a . Wout^T), so :func:`split_cuda` splits it as it lies; it is
MN-major for the backwards' products, which contract its out dimension
(K8's dattn = dz . Wout, K9's da = dz . W2 and du = dh . W1, K7's du =
dqkv . Wqkv), so :func:`split_t_cuda` writes W^T split. Nothing is kept
across calls: the weights change with every optimizer step.

They replace no TPU kernel: the JAX package's kernels read their weights
as they lie (neurovit_tpu/ops/fused_outproj.py:44 and :56, fused_mlp.py:108
and :141, fused_qkv.py:57 and :71). Bounded by their bytes: W read once,
big and small written once.
"""

from __future__ import annotations

import torch

from neurovit_tpu_torch.ops.common import (I64, INT, VOID, check_operand,
                                           launch, ptr)

# A block turns a 32 x 32 tile of W with 32 x 8 threads.
SPLIT_TILE, SPLIT_THREADS = 32, 256
# The plain split: 256 threads a block, four f32 a thread and step, at most
# 1056 blocks (eight an SM of the card's 132) walking the weight.
SPLIT_BLOCKS = 1056
# The 3xTF32 GEMMs (tf32x3_wgmma.cuh Loop): a 128 x 128 tile a block of two
# consumer warpgroups and the producer warp, a ring of four stages of three
# 16 KiB boxes (A, big, small), its barriers and 1 KiB to align the ring:
# one block an SM.
TILE, STAGES, THREADS = 128, 4, 2 * 128 + 32
SMEM = 1024 + STAGES * 3 * TILE * 128 + 2 * STAGES * 8


def gemm_launch(name: str, m: int, n: int) -> tuple:
    """(name, grid, threads, dynamic shared memory bytes) of a 3xTF32 GEMM
    pass with an [m, n] output: one block a 128 x 128 tile, a grid of
    (column tiles, row tiles)."""
    return (name, (-(-n // TILE), -(-m // TILE)), THREADS, SMEM)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (finite x):
    0x1000 added to the bit pattern, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_launch(name: str, n: int) -> tuple:
    """(name, grid, threads, dynamic shared memory bytes) of the plain
    pre-pass of a weight of n f32: blocks for a vector of four f32 a
    thread, at most SPLIT_BLOCKS (``nvt_split_f32_blocks``)."""
    return (name, (min(-(-n // (4 * SPLIT_THREADS)), SPLIT_BLOCKS), 1),
            SPLIT_THREADS, 0)


def split_plain(w: torch.Tensor):
    """(big, small) of f32 W as it lies, in plain PyTorch, the kernel's
    bits."""
    w = w.float().contiguous()
    big = rna_tf32(w)
    return big, w - big


def split_cuda(w: torch.Tensor):
    """Launch the plain pre-pass on f32 W (any shape, its size a multiple
    of 4) on the current stream: (big, small), each of W's shape, f32,
    allocated here for this call."""
    check_operand("w", w, torch.float32)
    big, small = torch.empty_like(w), torch.empty_like(w)
    launch("nvt_split_f32", (VOID,) * 3 + (I64,), w, ptr(w), ptr(big),
           ptr(small), w.numel())
    split_cuda.launches += 1
    return big, small


split_cuda.launches = 0


def split_t_launch(rows: int, cols: int, name: str = "wsplit") -> tuple:
    """(name, grid, threads, dynamic shared memory bytes) of the pre-pass
    of a W [rows, cols]: one block a 32 x 32 tile, a grid of (column
    tiles, row tiles), its tile in static shared memory."""
    return (name, (-(-cols // SPLIT_TILE), -(-rows // SPLIT_TILE)),
            SPLIT_THREADS, 0)


def split_t_plain(w: torch.Tensor):
    """(big, small) of W^T [cols, rows] for f32 W [rows, cols], in plain
    PyTorch, the kernel's bits."""
    wt = w.float().t().contiguous()
    big = rna_tf32(wt)
    return big, wt - big


def split_t_cuda(w: torch.Tensor):
    """Launch the pre-pass on f32 W [rows, cols] on the current stream:
    (big, small), each [cols, rows] f32, allocated here for this call."""
    check_operand("w", w, torch.float32)
    rows, cols = w.shape
    big = w.new_empty(cols, rows)
    small = w.new_empty(cols, rows)
    launch("nvt_wsplit_f32", (VOID,) * 3 + (INT,) * 2, w, ptr(w),
           ptr(big), ptr(small), rows, cols)
    split_t_cuda.launches += 1
    return big, small


split_t_cuda.launches = 0
