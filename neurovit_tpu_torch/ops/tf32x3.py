"""The weight pre-pass of the f32 GEMMs that run in 3xTF32 on ``wgmma``
(``csrc/tf32x3_wgmma.cuh``; K8 at f32, ``ops/fused_outproj.py``).

``wgmma`` takes TF32 operands K-major only, and a torch Linear weight W
[out, in] is MN-major for a product that contracts its out dimension
(dattn = dz . Wout). So each call first writes W^T, already split for
3xTF32: big = W^T rounded to TF32 (10 mantissa bits, to nearest, ties away
from zero: ``cvt.rna.tf32.f32``) and small = W^T - big, which is exact, so
big + small == W^T bit for bit. Nothing is kept across calls: the weight
changes with every optimizer step.

It replaces no TPU kernel: the JAX package's K8 reads its weight [inner,
dim], K-major for this product, as it lies (neurovit_tpu/ops/fused_outproj.py
:56). Bounded by its bytes: W read once, big and small written once.
"""

from __future__ import annotations

import torch

from neurovit_tpu_torch.ops.common import INT, VOID, check_operand, launch, ptr

# A block turns a 32 x 32 tile of W with 32 x 8 threads.
SPLIT_TILE, SPLIT_THREADS = 32, 256


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (finite x):
    0x1000 added to the bit pattern, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_t_launch(rows: int, cols: int) -> tuple:
    """(name, grid, threads, dynamic shared memory bytes) of the pre-pass
    of a W [rows, cols]: one block a 32 x 32 tile, a grid of (column
    tiles, row tiles), its tile in static shared memory."""
    return ("wsplit", (-(-cols // SPLIT_TILE), -(-rows // SPLIT_TILE)),
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
