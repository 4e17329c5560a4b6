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
forward, K15 backward) on the walk :func:`pool_plan` lays out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from neurovit_tpu_torch.ops.common import (INT, SMEM_LIMIT, VOID, check_operand,
                                           is_training, launch, on_cpu, ptr,
                                           round_up)

KSIZE, STRIDE, PAD = 3, 2, 1
FLOAT_TYPES = (torch.bfloat16, torch.float32)
# The walk of both kernels: a persistent grid of at most this many blocks
# of 384 threads an SM (the kernels' __launch_bounds__), as many as the
# SM's 228 KB of shared memory hold, 1 KB of it reserved per block.
MAX_BLOCKS_PER_SM = {"fwd": 1, "bwd": 2}
SM_SMEM = 233472
# The H100's SMs, pool_plan's default; the wrappers pass their card's own.
SMS = 132
# Ring depths: K14's step reads three depth planes and stages the next
# step's two; K15's reads two od planes, and the ring runs two steps ahead.
SLOTS = {"fwd": 5, "bwd": 4}
# The rows a tile takes first: K14 2R + 1 input rows for R output rows,
# K15 2R input rows from R + 1 output rows; the largest R that fits. A
# step's fixed cost (its barriers, the copies' issue) spreads over more
# rows as R grows, and K14's shared boundary row costs less.
BAND_ROWS = (3, 2, 1)
# Shared memory a block keeps past its barriers: where the ring's staging
# stands (csrc/maxpool3d.cu, Cursor).
CURSOR_BYTES = 128
# A work item's own cost in steps of its depth walk, when the chunks are
# chosen: the plane it stages again at its chunk's edge and its ramp.
ITEM_COST = 0.5


def out_dim(n: int) -> int:
    return (n + 2 * PAD - KSIZE) // STRIDE + 1


class PoolPass(NamedTuple):
    """How one kernel (K14 ``fwd`` or K15 ``bwd``) walks a shape.

    A work item is one batch item, a band of ``rows`` output rows (K15:
    the 2 * rows input rows below them), a tile of ``cols`` output columns
    (K15: 2 * cols input columns) and ``chans`` channels, and one of
    ``chunks`` even runs of od; items are numbered band fastest, then the
    column tile, the channel tile, the chunk and the batch item
    (:func:`pool_item`). Block i of ``grid`` takes items i, i + grid, ...
    and walks each item's od run in order, its depth planes staged in a
    ring of ``slots`` slots in shared memory: by ``cp.async.bulk`` where
    ``bulk``, else by ordinary loads. ``vec`` channels a thread."""
    rows: int
    cols: int
    chans: int
    chunks: int
    slots: int
    bulk: bool
    vec: int
    items: int
    grid: int
    smem_bytes: int


class PoolPlan(NamedTuple):
    fwd: PoolPass
    bwd: PoolPass


class PoolItem(NamedTuple):
    """One work item's box, each range [start, stop): the output depths
    ``od`` it walks and its ``chans``; K14 writes ``out_rows`` x
    ``out_cols`` from the staged ``in_rows`` x ``in_cols``, K15 writes
    ``in_rows`` x ``in_cols`` from the staged ``out_rows`` x ``out_cols``;
    ``planes``: the depths it stages, K14's of x, K15's of g and the
    codes, one ring slot each."""
    b: int
    od: Tuple[int, int]
    chans: Tuple[int, int]
    in_rows: Tuple[int, int]
    in_cols: Tuple[int, int]
    out_rows: Tuple[int, int]
    out_cols: Tuple[int, int]
    planes: Tuple[int, int]


def pool_item(kind: str, shape: Sequence[int], p: PoolPass,
              i: int) -> PoolItem:
    """The box of work item ``i`` of pass ``p`` (``kind`` "fwd" or "bwd")
    over x's ``shape``, decoded as the kernels decode it."""
    _, d, h, w, c = shape
    od, oh, ow = out_dim(d), out_dim(h), out_dim(w)
    bands, wtiles = -(-oh // p.rows), -(-ow // p.cols)
    ctiles = -(-c // p.chans)
    band, i = i % bands, i // bands
    wt, i = i % wtiles, i // wtiles
    ct, i = i % ctiles, i // ctiles
    chunk, b = i % p.chunks, i // p.chunks
    od_run = (chunk * od // p.chunks, (chunk + 1) * od // p.chunks)
    chans = (ct * p.chans, min(c, (ct + 1) * p.chans))
    if kind == "fwd":
        rows = (band * p.rows, min(oh, (band + 1) * p.rows))
        cols = (wt * p.cols, min(ow, (wt + 1) * p.cols))
        return PoolItem(b, od_run, chans,
                        (max(0, 2 * rows[0] - 1), min(h, 2 * rows[1])),
                        (max(0, 2 * cols[0] - 1), min(w, 2 * cols[1])),
                        rows, cols,
                        (max(0, 2 * od_run[0] - 1), min(d, 2 * od_run[1])))
    rows = (2 * p.rows * band, min(h, 2 * p.rows * (band + 1)))
    cols = (2 * p.cols * wt, min(w, 2 * p.cols * (wt + 1)))
    return PoolItem(b, od_run, chans, rows, cols,
                    (rows[0] // 2, min(oh, rows[1] // 2 + 1)),
                    (cols[0] // 2, min(ow, cols[1] // 2 + 1)),
                    (od_run[0], min(od, od_run[1] + 1)))


def pool_smem_bytes(kind: str, shape: Sequence[int], elt: int, rows: int,
                    cols: int, chans: int, slots: int) -> int:
    """Shared memory of one block (``nvt_maxpool3d_smem_bytes`` counts the
    same): the ring's slots, each the tile's staged rows at a pitch rounded
    up to 16 bytes (K14: x; K15: g, then the codes), K14's kd codes of the
    depth combine, a barrier a slot and the ring's cursor."""
    _, _, h, w, _ = shape
    if kind == "fwd":
        srows, scols = min(h, 2 * rows + 1), min(w, 2 * cols + 1)
        pitch = round_up(scols * chans * elt, 16)
        cpitch = round_up(scols * chans, 16)
        return (slots * srows * pitch + srows * cpitch + 8 * slots
                + CURSOR_BYTES)
    srows, scols = min(out_dim(h), rows + 1), min(out_dim(w), cols + 1)
    pitch = round_up(scols * chans * elt, 16)
    cpitch = round_up(scols * chans, 16)
    return slots * srows * (pitch + cpitch) + 8 * slots + CURSOR_BYTES


def _bulk_ok(row_elems: int, c: int, chans: int, whole_rows: bool,
             elts: Sequence[int]) -> bool:
    """Whether every staged segment starts on 16 bytes and is a multiple of
    16 long, as ``cp.async.bulk`` needs: whole rows of ``row_elems``, or
    runs of ``chans`` channels at a stride of ``c``."""
    if whole_rows and chans == c:
        return all(row_elems * e % 16 == 0 for e in elts)
    return all(c * e % 16 == 0 and chans * e % 16 == 0 for e in elts)


def _tile(kind: str, shape: Sequence[int], elt: int, slots: int):
    """(rows, cols, chans) of the largest tile whose ring fits a block's
    shared memory: whole rows and all channels, R = 2 then 1; then fewer
    columns, then fewer channels (multiples of 8 where C is), by halves."""
    c = shape[4]
    oh, ow = out_dim(shape[2]), out_dim(shape[3])

    def fits(r, tw, ct):
        return pool_smem_bytes(kind, shape, elt, r, tw, ct,
                               slots) <= SMEM_LIMIT

    for r in BAND_ROWS:
        if fits(min(r, oh), ow, c):
            return min(r, oh), ow, c
    r, tw, ct = BAND_ROWS[-1], ow, c
    while tw > 1 and not fits(r, tw, ct):
        tw = (tw + 1) // 2
    q = 8 if c % 8 == 0 else 1
    while not fits(r, tw, ct):
        ct = max(q, ct // 2 // q * q)
    return r, tw, ct


def _pass(kind: str, shape: Sequence[int], elt: int, sms: int) -> PoolPass:
    b, d, h, w, c = shape
    od, oh, ow = out_dim(d), out_dim(h), out_dim(w)
    slots = SLOTS[kind]
    rows, cols, chans = _tile(kind, shape, elt, slots)
    smem = pool_smem_bytes(kind, shape, elt, rows, cols, chans, slots)
    whole = cols >= ow
    if kind == "fwd":
        bulk = _bulk_ok(w * c, c, chans, whole, (elt,))
    else:
        bulk = _bulk_ok(ow * c, c, chans, whole, (elt, 1))
    vec = 8 if c % 8 == 0 and chans % 8 == 0 else 1
    per_sm = max(1, min(MAX_BLOCKS_PER_SM[kind], SM_SMEM // (smem + 1024)))
    capacity = sms * per_sm
    tiles = b * -(-oh // rows) * -(-ow // cols) * -(-c // chans)
    # Depth chunks: the count whose rounds of items over the resident
    # blocks, each round as long as its longest item, finish first.
    best = None
    for chunks in range(1, od + 1):
        rounds = -(-tiles * chunks // capacity)
        cost = rounds * (-(-od // chunks) + ITEM_COST)
        if best is None or cost < best[0]:
            best = (cost, chunks)
    chunks = best[1]
    items = tiles * chunks
    return PoolPass(rows, cols, chans, chunks, slots, bulk, vec, items,
                    min(items, capacity), smem)


@functools.lru_cache(maxsize=256)
def _plan(shape: Tuple[int, ...], elt: int, sms: int) -> PoolPlan:
    return PoolPlan(_pass("fwd", shape, elt, sms),
                    _pass("bwd", shape, elt, sms))


def pool_plan(shape: Sequence[int], dtype: torch.dtype,
              sms: int = SMS) -> PoolPlan:
    """K14's and K15's walk of x's ``shape`` [B, D, H, W, C] in ``dtype``
    (bf16 or f32) on a card of ``sms`` SMs: the tile, the depth chunks,
    the ring and the grid of each. Takes every shape with positive dims;
    a tile shrinks until its ring fits a block's shared memory."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != 5 or min(shape) < 1:
        raise ValueError(f"the pool takes x [B, D, H, W, C] with every dim "
                         f">= 1, got {shape}")
    if dtype not in FLOAT_TYPES:
        raise TypeError(f"the pool takes bf16 or f32, got {dtype}")
    return _plan(shape, 2 if dtype == torch.bfloat16 else 4, int(sms))


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


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _walk_args(p: PoolPass) -> tuple:
    return (p.rows, p.cols, p.chans, p.chunks, p.slots, int(p.bulk), p.grid)


def max_pool3d_argmax_cuda(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel K14 on NDHWC bf16 or f32 ``x``, on
    :func:`pool_plan`'s walk."""
    _check_float("x", x)
    check_operand("x", x, x.dtype)
    b, d, h, w, c = x.shape
    shape = (b, out_dim(d), out_dim(h), out_dim(w), c)
    plan = pool_plan(x.shape, x.dtype, _sm_count(x.device.index or 0)).fwd
    out = x.new_empty(shape)
    codes = torch.empty(shape, dtype=torch.uint8, device=x.device)
    launch("nvt_maxpool3d_fwd", (VOID,) * 3 + (INT,) * 13, x, ptr(x),
           ptr(out), ptr(codes), b, d, h, w, c,
           int(x.dtype == torch.bfloat16), *_walk_args(plan))
    max_pool3d_argmax_cuda.launches += 1
    return out, codes


max_pool3d_argmax_cuda.launches = 0


def max_pool3d_argmax_bwd_cuda(codes: torch.Tensor, g: torch.Tensor,
                               x_shape: Sequence[int],
                               dtype: torch.dtype) -> torch.Tensor:
    """Launch the Hopper kernel K15: dx [B, D, H, W, C] in ``dtype``, which
    must be g's, on :func:`pool_plan`'s walk."""
    b, d, h, w, c = (int(n) for n in x_shape)
    _check_float("g", g)
    if g.dtype != dtype:
        raise TypeError(f"the pool's backward writes dx in g's dtype; got g "
                        f"{g.dtype} for dx {dtype}")
    shape = (b, out_dim(d), out_dim(h), out_dim(w), c)
    check_operand("g", g, g.dtype, shape)
    check_operand("codes", codes, torch.uint8, shape)
    plan = pool_plan((b, d, h, w, c), dtype,
                     _sm_count(g.device.index or 0)).bwd
    dx = g.new_empty((b, d, h, w, c))
    launch("nvt_maxpool3d_bwd", (VOID,) * 3 + (INT,) * 13, g, ptr(codes),
           ptr(g), ptr(dx), b, d, h, w, c, int(g.dtype == torch.bfloat16),
           *_walk_args(plan))
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
