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

Head dims: the kernels (TMA + ``wgmma``, 128-byte swizzled rows of 64
bf16) are instances for D in :data:`FWD_HEAD_DIMS` (64, 128). Any other D
from 8 to 128 is zero-padded along D to the next instance and the result
sliced back (:func:`pad_head_dim`): zero columns add nothing to q . k or
dO . v, and the columns of o, dq, dk and dv they produce are dropped.
:func:`flash_fwd_plan` and :func:`flash_bwd_plan` give the launches. D < 8
takes the plain attention on every device, by shape alone, where JAX leaves
Pallas for its dense XLA path (flash_attention.py:517-520); D > 128 is
refused.

f32 CUDA tensors run ``csrc/flash_attention_f32.cu`` (K1 and K6 at f32,
:func:`flash_f32_plan`: the bf16 K1's TMA ring, both products in 3xTF32
on the tensor cores, ``csrc/tf32x3.cuh``) and
``csrc/flash_attention_bwd_f32.cu`` (K5 and K6's backward at f32,
:func:`flash_f32_bwd_plan`: the bf16 K5's two passes, every product in
3xTF32), each layout a template
instance with its own launch symbol and count, as in bf16: P and dS not
rounded, as the TPU kernels compute at f32, with instances for D in
:data:`F32_HEAD_DIMS` (32, 64, 128) and the same zero-padding of the
others.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops.common import (FLOAT, INT, SHAPE_QUEUE, U64, VOID,
                                           check_operand, check_smem,
                                           dropout_args, is_training, launch,
                                           on_cpu, pick, ptr)

LOG2E = 1.4426950408889634
SCORE_CAP = 96.0
LAYOUTS = ("bnhd", "bhnd")
# The head dims the attention kernels take, each rounded up to the next of
# HEAD_DIMS (kernel_head_dim) and then padded to an instance of
# FWD_HEAD_DIMS; below MIN_KERNEL_HEAD_DIM the plain attention runs on
# every device.
HEAD_DIMS = (16, 32, 64, 128)
MIN_KERNEL_HEAD_DIM = 8


def kernel_head_dim(d: int) -> int:
    """The kernel instance a head dim ``d`` runs in: the smallest of
    :data:`HEAD_DIMS` that holds it. Raises for d < 8 (the plain attention's
    shapes) and d > 128."""
    if d < MIN_KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {d} < {MIN_KERNEL_HEAD_DIM} runs the plain "
                         "attention, not a kernel")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"the attention kernels take head dim <= "
                         f"{HEAD_DIMS[-1]}, got {d} ({SHAPE_QUEUE})")
    return next(h for h in HEAD_DIMS if h >= d)


# The kernels' launches (csrc/flash_attention.cu, flash_attention_bwd.cu,
# flash_attention.cuh): head-dim instances, keys per tile, ring stages,
# bytes of a row's Philox window (five 16-byte blocks), the SMs that a grid
# of 128-row blocks must fill (else 64-row blocks), and the slack that
# aligns the tiles to 1024 bytes. The grids are one-dimensional (row tiles
# times B * H) and the backward indexes the [B, H, N] statistics' rows in
# 32 bits: B * H * N rounded up to 64 stays below 2^31.
FWD_HEAD_DIMS = (64, 128)
FWD_BKV, FWD_STAGES, FWD_WINDOW_BYTES = 64, 3, 80
FWD_SMS = 132
FWD_ALIGN_SLACK = 1024
MAX_GRID_X = 2 ** 31 - 1
BWD_STAGES = 3
BWD_STAT_BYTES = 64 * 4
# K1 and K6 at f32 (csrc/flash_attention_f32.cu): head-dim instances,
# query rows a block (four warps of 16), keys a ring stage, the ring's
# stages (two at head dim 128) and threads a block; the TMA boxes are
# 128-byte swizzled, FWD_ALIGN_SLACK aligning them to 1024 bytes.
F32_HEAD_DIMS = (32, 64, 128)
F32_BQ, F32_BKV, F32_THREADS = 64, 32, 128
# K5 and K6's backward at f32 (csrc/flash_attention_bwd_f32.cu): rows a
# block of either pass (query rows in pass 1, keys in pass 2, 16 a warp),
# keys a tile of pass 1 and queries a tile of pass 2, pass 2's columns of
# dK and dV a block, and the floats a staged row takes beyond the head dim
# (rows D + 4 apart: conflict-free fragment loads, csrc/tf32x3.cuh).
F32_BWD_ROWS, F32_BWD_TILE, F32_BWD_COLS, F32_BWD_PAD = 64, 32, 64, 4


class FwdPlan(NamedTuple):
    """How one launch of the forward (K1 or K6) covers [B, N, H, D]: the
    kernel's head-dim instance ``d_kernel`` (q, k and v zero-padded to
    it), ``bq`` query rows a block (64 per consumer warpgroup) on a grid of
    (q tiles, B * H), q tiles fastest, linearised into the grid's x, so that
    a head's tiles run together and its K/V stay in L2; ``bkv`` keys a tile
    through a ring of ``stages``; ``smem`` bytes of dynamic shared memory a
    block, each tile
    on a 1024-byte boundary at ``offsets`` (Q, K ring, V ring, dropout
    windows, barriers) from the aligned base; ``tmap_dims`` the tensor
    maps' dims, innermost first, ordered by the layout so that a box never
    crosses a head."""
    d_kernel: int
    bq: int
    bkv: int
    stages: int
    grid: tuple
    smem: int
    offsets: tuple
    tmap_dims: tuple


def fwd_head_dim(d: int) -> int:
    """The attention kernels' instance for head dim ``d``: 64 or 128."""
    return next(h for h in FWD_HEAD_DIMS if h >= kernel_head_dim(d))


def _block_rows(b: int, n: int, h: int) -> int:
    """128-row blocks (two consumer warpgroups) where b * h * ceil(n / 128)
    fills the card's 132 SMs, else 64."""
    return 128 if b * h * -(-n // 128) >= FWD_SMS else 64


def _check_grid(what: str, b: int, n: int, h: int) -> None:
    if b * h * -(-n // 64) * 64 > MAX_GRID_X:
        raise ValueError(f"the attention {what} takes B * H * N < 2^31 (its "
                         f"grid and row coordinates), got B {b}, H {h}, N "
                         f"{n} ({SHAPE_QUEUE})")


def _offsets(*sizes: int) -> tuple:
    """Offsets of consecutive regions of ``sizes`` bytes, and their end."""
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += size
    return tuple(offsets), at


def flash_fwd_plan(b: int, n: int, h: int, d: int, layout: str) -> FwdPlan:
    """The forward kernel's plan for q, k, v of batch ``b``, ``n`` tokens,
    ``h`` heads of ``d`` in ``layout``: 128-row blocks (two consumer
    warpgroups) where b * h * ceil(n / 128) fills the card's 132 SMs, else
    64-row blocks. Raises where the kernel does not take the shape."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    d_kernel = fwd_head_dim(d)
    _check_grid("forward", b, n, h)
    bq = _block_rows(b, n, h)
    kv_bytes = FWD_STAGES * FWD_BKV * d_kernel * 2
    offsets, at = _offsets(bq * d_kernel * 2, kv_bytes, kv_bytes,
                           bq * FWD_WINDOW_BYTES, (2 * FWD_STAGES + 1) * 8)
    smem = FWD_ALIGN_SLACK + at
    check_smem("attention forward", smem)
    dims = ((d_kernel, h, n, b) if layout == "bnhd" else (d_kernel, n, h, b))
    return FwdPlan(d_kernel=d_kernel, bq=bq, bkv=FWD_BKV, stages=FWD_STAGES,
                   grid=(-(-n // bq), b * h), smem=smem,
                   offsets=offsets, tmap_dims=dims)


class F32FwdPlan(NamedTuple):
    """How one launch of K1 or K6 at f32 covers [B, N, H, D] or
    [B, H, N, D] (the layout moves only where a head's rows lie): the
    head-dim instance ``d_kernel`` (q, k and v zero-padded to it), ``bq``
    query rows a block of ``threads`` on a one-dimensional grid of (q
    tiles x B * H), q tiles fastest; ``bkv`` keys a stage of the K and V
    ring, ``stages`` of them; ``smem`` bytes of dynamic shared memory a
    block (the alignment slack, the Q box, the ring, its full and empty
    mbarriers and Q's, all boxes f32)."""
    d_kernel: int
    bq: int
    bkv: int
    stages: int
    threads: int
    grid: tuple
    smem: int


def f32_head_dim(d: int) -> int:
    """K1 f32's instance for head dim ``d``: 32, 64 or 128."""
    return next(h for h in F32_HEAD_DIMS if h >= kernel_head_dim(d))


def flash_f32_plan(b: int, n: int, h: int, d: int) -> F32FwdPlan:
    """The f32 forward's plan for q, k, v of batch ``b``, ``n`` tokens,
    ``h`` heads of ``d``, in either layout: K1 (bnhd) and K6 (bhnd) at f32
    share the grid and the shared memory, since the layout moves only
    where a head's rows lie (the kernel's own count of the shared memory
    is ``nvt_flash_attention_f32_smem_bytes``). Raises where the kernel
    does not take the shape: the head dims and grids K1 takes in bf16."""
    d_kernel = f32_head_dim(d)
    _check_grid("forward", b, n, h)
    stages = 2 if d_kernel == 128 else 3
    smem = (FWD_ALIGN_SLACK + (F32_BQ + 2 * stages * F32_BKV) * d_kernel * 4
            + (2 * stages + 1) * 8)
    check_smem("attention forward", smem)
    return F32FwdPlan(d_kernel=d_kernel, bq=F32_BQ, bkv=F32_BKV,
                      stages=stages, threads=F32_THREADS,
                      grid=(-(-n // F32_BQ) * b * h,), smem=smem)


class F32BwdPlan(NamedTuple):
    """How one launch of K5 or K6's backward at f32 covers [B, N, H, D] or
    [B, H, N, D]: the head-dim instance ``d_kernel`` (every operand
    zero-padded to it); ``rows`` rows a block of ``threads`` (four warps of
    16 rows) in both passes (query rows in pass 1, keys in pass 2),
    ``tile`` keys a tile of pass 1 and queries a tile of pass 2; pass 2's
    blocks each take ``cols`` columns of dK and dV (two blocks split D =
    128); staged rows ``ld`` floats apart; the one-dimensional grids
    ``dq_grid`` (q tiles x B * H) and ``dkv_grid`` (key tiles x column
    parts x B * H), tiles fastest; ``dq_smem`` (Q, dO, two K and two V
    tiles) and ``dkv_smem`` (K, V, two Q and two dO tiles, two tiles' l and
    delta) bytes of dynamic shared memory a block, all f32."""
    d_kernel: int
    rows: int
    tile: int
    cols: int
    ld: int
    threads: int
    dq_grid: tuple
    dkv_grid: tuple
    dq_smem: int
    dkv_smem: int


def flash_f32_bwd_plan(b: int, n: int, h: int, d: int) -> F32BwdPlan:
    """The f32 backward's plan for q, k, v, o, dO of batch ``b``, ``n``
    tokens, ``h`` heads of ``d``, in either layout: K5 (bnhd) and K6's
    backward (bhnd) at f32 share the grids and the shared memory (the
    kernel's own count of the latter is
    ``nvt_flash_attention_f32_bwd_smem_bytes``). Raises where the kernel
    does not take the shape: the head dims and grids K5 takes in bf16."""
    d_kernel = f32_head_dim(d)
    _check_grid("backward", b, n, h)
    rows, tile = F32_BWD_ROWS, F32_BWD_TILE
    cols = min(d_kernel, F32_BWD_COLS)
    ld = d_kernel + F32_BWD_PAD
    dq_smem = (2 * rows + 4 * tile) * ld * 4
    dkv_smem = ((2 * rows + 4 * tile) * ld + 4 * tile) * 4
    check_smem("attention backward", max(dq_smem, dkv_smem))
    tiles = -(-n // rows)
    return F32BwdPlan(d_kernel=d_kernel, rows=rows, tile=tile, cols=cols,
                      ld=ld, threads=F32_THREADS, dq_grid=(tiles * b * h,),
                      dkv_grid=(tiles * (d_kernel // cols) * b * h,),
                      dq_smem=dq_smem, dkv_smem=dkv_smem)


class BwdPlan(NamedTuple):
    """How one launch of the backward (K5 or K6's) covers [B, N, H, D]: the
    head-dim instance ``d_kernel`` (every operand zero-padded to it);
    ``rows`` rows a block in both passes (64 per consumer warpgroup: query
    rows in pass 1, keys in pass 2) on a grid of (row tiles, B * H), row
    tiles fastest, linearised into the grid's x; ``bkv`` keys a tile of
    pass 1 and 64 queries a tile of pass 2, both through rings of
    ``stages``; ``nq`` queries a sub-tile of pass 2 (its S^T and dP^T are
    64 x nq); ``dq_smem`` and ``dkv_smem`` bytes of dynamic shared memory a
    block of each pass, each tile on a 1024-byte boundary at
    ``dq_offsets`` (Q, dO, K ring, V ring, dropout windows, barriers) and
    ``dkv_offsets`` (K, V, Q ring, dO ring, statistics ring, dropout byte
    tiles, barriers) from the aligned base; ``tmap_dims`` the bf16 tensor
    maps' dims, innermost first, ordered by the layout."""
    d_kernel: int
    rows: int
    bkv: int
    nq: int
    stages: int
    grid: tuple
    dq_smem: int
    dq_offsets: tuple
    dkv_smem: int
    dkv_offsets: tuple
    tmap_dims: tuple


def flash_bwd_plan(b: int, n: int, h: int, d: int, layout: str) -> BwdPlan:
    """The backward kernels' plan for q, k, v, o, dO of batch ``b``, ``n``
    tokens, ``h`` heads of ``d`` in ``layout``: the forward's block heights
    (128 rows where b * h * ceil(n / 128) fills the card's 132 SMs), and
    pass 2's sub-tiles of 32 queries at D = 128 (the dK and dV accumulators
    take 128 registers a thread there), else 64. Raises where the kernels
    do not take the shape."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    d_kernel = fwd_head_dim(d)
    _check_grid("backward", b, n, h)
    rows = _block_rows(b, n, h)
    tile = FWD_BKV * d_kernel * 2
    block = rows * d_kernel * 2
    nq = 64 if d_kernel == 64 else 32
    barriers = (2 * BWD_STAGES + 1) * 8
    dq_offsets, at = _offsets(block, block, BWD_STAGES * tile,
                              BWD_STAGES * tile, rows * FWD_WINDOW_BYTES,
                              barriers)
    dq_smem = FWD_ALIGN_SLACK + at
    consumers = rows // 64
    dkv_offsets, at = _offsets(block, block, BWD_STAGES * tile,
                               BWD_STAGES * tile,
                               BWD_STAGES * 2 * BWD_STAT_BYTES,
                               consumers * 2 * nq * FWD_WINDOW_BYTES,
                               barriers)
    dkv_smem = FWD_ALIGN_SLACK + at
    check_smem("attention backward", max(dq_smem, dkv_smem))
    dims = ((d_kernel, h, n, b) if layout == "bnhd" else (d_kernel, n, h, b))
    return BwdPlan(d_kernel=d_kernel, rows=rows, bkv=FWD_BKV, nq=nq,
                   stages=BWD_STAGES, grid=(-(-n // rows), b * h),
                   dq_smem=dq_smem, dq_offsets=dq_offsets, dkv_smem=dkv_smem,
                   dkv_offsets=dkv_offsets, tmap_dims=dims)


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` zero-padded along its last dim to ``d`` (itself if already d
    wide), contiguous."""
    pad = d - t.shape[-1]
    return F.pad(t, (0, pad)) if pad else t


def uses_kernel(q: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """The dispatch rule of the attention ops: the kernel for CUDA operands
    of head dim >= 8, the plain version for CPU operands and, on every
    device, for head dim < 8."""
    return not on_cpu(q, *tensors) and q.shape[-1] >= MIN_KERNEL_HEAD_DIM


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


def _check_qkv(q, k, v, dtype=torch.bfloat16) -> int:
    """Check the operands of a launch; returns the kernel's head dim."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, dtype, q.shape)
    return kernel_head_dim(q.shape[3])


def _fwd_cuda(symbol, layout, q, k, v, *, scale, n_valid, dropout_rate, seed,
              return_stats, f32=False):
    _check_qkv(q, k, v, torch.float32 if f32 else torch.bfloat16)
    b, n, h, d = _dims(q, layout)
    d_kernel = (flash_f32_plan(b, n, h, d) if f32
                else flash_fwd_plan(b, n, h, d, layout)).d_kernel
    n_valid = _n_valid(q, n_valid, layout)
    inv_keep, keep_q = dropout_args(dropout_rate)
    q, k, v = (pad_head_dim(t, d_kernel) for t in (q, k, v))
    o = torch.empty_like(q)
    lsum = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
            if return_stats else None)
    launch(symbol, (VOID,) * 4 + (INT,) * 5 + (FLOAT, FLOAT, INT, U64, VOID),
           q, ptr(q), ptr(k), ptr(v), ptr(o), b, n, h, d_kernel, n_valid,
           float(scale * LOG2E), 1.0 / inv_keep, keep_q, int(seed), ptr(lsum))
    if d_kernel != d:
        o = o[..., :d].contiguous()
    return (o, lsum) if return_stats else o


def _bwd_cuda(symbol, layout, q, k, v, o, do, lsum, *, scale, n_valid,
              dropout_rate, seed, f32=False):
    dtype = torch.float32 if f32 else torch.bfloat16
    _check_qkv(q, k, v, dtype)
    b, n, h, d = _dims(q, layout)
    d_kernel = (flash_f32_bwd_plan(b, n, h, d) if f32
                else flash_bwd_plan(b, n, h, d, layout)).d_kernel
    check_operand("o", o, dtype, q.shape)
    check_operand("do", do, dtype, q.shape)
    check_operand("lsum", lsum, torch.float32, (b, h, n))
    inv_keep, keep_q = dropout_args(dropout_rate)
    keep = 1.0 / inv_keep
    q, k, v, o, do = (pad_head_dim(t, d_kernel) for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    launch(symbol, (VOID,) * 10 + (INT,) * 5 + (FLOAT,) * 4 + (INT, U64), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lsum), ptr(delta),
           ptr(dq), ptr(dk), ptr(dv), b, n, h, d_kernel, int(n_valid),
           float(scale * LOG2E), float(scale / keep), keep, inv_keep, keep_q,
           int(seed))
    if d_kernel != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, n_valid: Optional[int] = None,
                         dropout_rate: float = 0.0, seed: int = 0,
                         return_stats: bool = False):
    """Launch the Hopper kernel K1: bf16 [B, N, H, D], contiguous, 8 <= D
    <= 128."""
    out = _fwd_cuda("nvt_flash_attention_fwd", "bnhd", q, k, v, scale=scale,
                    n_valid=n_valid, dropout_rate=dropout_rate, seed=seed,
                    return_stats=return_stats)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_f32_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float,
                             n_valid: Optional[int] = None,
                             dropout_rate: float = 0.0, seed: int = 0,
                             return_stats: bool = False):
    """Launch K1 at f32 (:func:`flash_f32_plan`): f32 [B, N, H, D],
    contiguous, 8 <= D <= 128; both products in 3xTF32 on the tensor
    cores."""
    out = _fwd_cuda("nvt_flash_attention_f32_fwd", "bnhd", q, k, v,
                    scale=scale, n_valid=n_valid, dropout_rate=dropout_rate,
                    seed=seed, return_stats=return_stats, f32=True)
    flash_attention_f32_cuda.launches += 1
    return out


flash_attention_f32_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, do, lsum, *, scale: float,
                             n_valid: int, dropout_rate: float = 0.0,
                             seed: int = 0):
    """Launch the Hopper kernel K5 (two passes: dQ with delta, then dK and
    dV, on TMA + ``wgmma``); returns dq, dk, dv [B, N, H, D] bf16."""
    out = _bwd_cuda("nvt_flash_attention_bwd", "bnhd", q, k, v, o, do, lsum,
                    scale=scale, n_valid=n_valid, dropout_rate=dropout_rate,
                    seed=seed)
    flash_attention_bwd_cuda.launches += 1
    return out


flash_attention_bwd_cuda.launches = 0


def flash_attention_bwd_f32_cuda(q, k, v, o, do, lsum, *, scale: float,
                                 n_valid: int, dropout_rate: float = 0.0,
                                 seed: int = 0):
    """Launch K5 at f32 (:func:`flash_f32_bwd_plan`: dQ with delta, then dK
    and dV, f32 products in 3xTF32 on the tensor cores); returns dq, dk, dv
    [B, N, H, D] f32."""
    out = _bwd_cuda("nvt_flash_attention_f32_bwd", "bnhd", q, k, v, o, do,
                    lsum, scale=scale, n_valid=n_valid,
                    dropout_rate=dropout_rate, seed=seed, f32=True)
    flash_attention_bwd_f32_cuda.launches += 1
    return out


flash_attention_bwd_f32_cuda.launches = 0


def flash_attention_bhnd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              n_valid: Optional[int] = None,
                              dropout_rate: float = 0.0, seed: int = 0,
                              return_stats: bool = False):
    """Launch the Hopper kernel K6: bf16 [B, H, N, D], contiguous, 8 <= D
    <= 128, read and written in place (no transpose to bnhd)."""
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
    dq, dk, dv [B, H, N, D] bf16."""
    out = _bwd_cuda("nvt_flash_attention_bhnd_bwd", "bhnd", q, k, v, o, do,
                    lsum, scale=scale, n_valid=n_valid,
                    dropout_rate=dropout_rate, seed=seed)
    flash_attention_bhnd_bwd_cuda.launches += 1
    return out


flash_attention_bhnd_bwd_cuda.launches = 0


def flash_attention_bhnd_f32_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, scale: float,
                                  n_valid: Optional[int] = None,
                                  dropout_rate: float = 0.0, seed: int = 0,
                                  return_stats: bool = False):
    """Launch K6 at f32 (:func:`flash_f32_plan`): f32 [B, H, N, D],
    contiguous, 8 <= D <= 128, read and written in place; both products
    in 3xTF32 on the tensor cores."""
    out = _fwd_cuda("nvt_flash_attention_bhnd_f32_fwd", "bhnd", q, k, v,
                    scale=scale, n_valid=n_valid, dropout_rate=dropout_rate,
                    seed=seed, return_stats=return_stats, f32=True)
    flash_attention_bhnd_f32_cuda.launches += 1
    return out


flash_attention_bhnd_f32_cuda.launches = 0


def flash_attention_bhnd_bwd_f32_cuda(q, k, v, o, do, lsum, *, scale: float,
                                      n_valid: int, dropout_rate: float = 0.0,
                                      seed: int = 0):
    """Launch K6's backward at f32 (K5 f32's two passes in the bhnd
    layout, :func:`flash_f32_bwd_plan`); returns dq, dk, dv [B, H, N, D]
    f32."""
    out = _bwd_cuda("nvt_flash_attention_bhnd_f32_bwd", "bhnd", q, k, v, o,
                    do, lsum, scale=scale, n_valid=n_valid,
                    dropout_rate=dropout_rate, seed=seed, f32=True)
    flash_attention_bhnd_bwd_f32_cuda.launches += 1
    return out


flash_attention_bhnd_bwd_f32_cuda.launches = 0

# Per layout: the forward's and the backward's (plain, bf16 kernel, f32
# kernel).
_IMPLS = {
    "bnhd": ((flash_attention_plain, flash_attention_cuda,
              flash_attention_f32_cuda),
             (flash_attention_bwd_plain, flash_attention_bwd_cuda,
              flash_attention_bwd_f32_cuda)),
    "bhnd": ((flash_attention_bhnd_plain, flash_attention_bhnd_cuda,
              flash_attention_bhnd_f32_cuda),
             (flash_attention_bhnd_bwd_plain, flash_attention_bhnd_bwd_cuda,
              flash_attention_bhnd_bwd_f32_cuda)),
}


def _impl(layout: str, backward: bool, q: torch.Tensor,
          *tensors: torch.Tensor):
    """The forward (or backward) of a call: the plain version where
    ``uses_kernel`` says so (CPU operands, head dim < 8), else
    ``common.pick``'s (plain, K1 or K6, K1 or K6 at f32; plain, K5 or K6's
    backward, at bf16 or f32)."""
    impls = _IMPLS[layout][backward]
    if not uses_kernel(q, *tensors):
        return impls[0]
    return pick(*impls, q, *tensors)


class FlashAttention(torch.autograd.Function):
    """K1 forward and K5 backward (bnhd), or K6 forward and backward
    (bhnd). Residuals: q, k, v, the output and the f32 row sums (the output
    is the out-projection's input and is held anyway); the seed regenerates
    the mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid, dropout_rate, seed, layout):
        fwd = _impl(layout, False, q, k, v)
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
        bwd = _impl(ctx.layout, True, q, do)
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
    version, CUDA tensors the kernels (bf16 or f32, either layout; head
    dim < 8: the plain version on either device)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n_valid = _n_valid(q, n_valid, layout)
    if is_training(q, k, v):
        return FlashAttention.apply(q, k, v, scale, n_valid,
                                    float(dropout_rate), int(seed), layout)
    fn = _impl(layout, False, q, k, v)
    return fn(q, k, v, scale=scale, n_valid=n_valid,
              dropout_rate=dropout_rate, seed=seed)
