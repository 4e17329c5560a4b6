"""The attention backward's launch plan (``ops/flash_attention.py``
``flash_bwd_plan``) as a pure function, and numpy models of how its second
pass (``csrc/flash_attention_bwd.cu``, dK and dV) lays the transposed
scores and the dropout bits over its threads.

The plan, at the flagship (batch 1, 8, 32, 128 x 1001 tokens, 8 heads of
64), at every width of ``models/vit3d.py`` WIDTHS and at the card tests'
shapes: the instance D (64 or 128), the forward's block heights (128 rows
where the grid fills the card's 132 SMs), sub-tiles of 32 queries at
D = 128 and 64 at D = 64, a grid of (row tiles, B * H) that covers N with
no spare tile, shared memory of both passes within the H100's 227 KiB with
every tile on a 1024-byte boundary, the tensor maps' dims ordered by the
layout, and refusals where the kernels refuse. The card tests hold the
plan's bytes and block rows to the kernels' own.

The models: pass 2's accumulators are S^T and dP^T, rows = keys and
columns = queries, in wgmma's m64nNQ layout (thread t holds d[4 j + i] at
key 16 (t / 32) + (t % 32) / 4 + 8 (i / 2), query 8 j + 2 (t % 4) + i %
2); their bf16 pairs, four per k16 chunk of queries, are the A operands of
dV += (P^T m) dO and dK += dS^T Q. For dropout, each warpgroup fills a byte
tile a sub-tile: for each query row the five Philox blocks from the one
that holds the warpgroup's first key, 5 NQ blocks over 128 threads; each
thread then reads its bytes by position, at an offset it computes from the
32-bit low word of the row's index. The model runs that tile by tile and
checks that every thread reads, at every (key, query) it holds, the byte
that ``nn.keep_mask`` gives there.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

FLAGSHIP = [(b, 1001, 8, 64) for b in (1, 8, 32, 128)]
WIDTH_SHAPES = [(b, n, heads, dh) for _, heads, dh, _ in WIDTHS.values()
                for b in (1, 2, 8) for n in (130, 1001)]
# tests/test_torch_cuda.py's backward cases: head dims, token counts, block
# heights, and B * H past 65535.
CARD_SHAPES = ([(1, n, 2, d) for d in (16, 32, 64, 80, 128)
                for n in (64, 130, 1001)]
               + [(1, 1001, 8, 64), (8, 1001, 8, 64), (3, 130, 11, 64),
                  (40, 130, 4, 128), (2, 70, 3, 64), (2, 1001, 8, 128),
                  (8193, 16, 8, 16)])
SHAPES = FLAGSHIP + WIDTH_SHAPES + CARD_SHAPES


@pytest.mark.parametrize("layout", fa.LAYOUTS)
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_flash_bwd_plan(b, n, h, d, layout):
    plan = fa.flash_bwd_plan(b, n, h, d, layout)
    assert plan.d_kernel == (64 if d <= 64 else 128)
    assert plan.d_kernel == fa.flash_fwd_plan(b, n, h, d, layout).d_kernel
    fills = b * h * -(-n // 128) >= 132
    assert plan.rows == (128 if fills else 64)
    assert plan.rows == fa.flash_fwd_plan(b, n, h, d, layout).bq
    assert plan.nq == (64 if plan.d_kernel == 64 else 32)
    assert plan.bkv == 64 and plan.stages >= 2
    tiles, heads = plan.grid
    assert heads == b * h
    assert (tiles - 1) * plan.rows < n <= tiles * plan.rows
    assert max(plan.dq_smem, plan.dkv_smem) <= SMEM_LIMIT
    tile = 64 * plan.d_kernel * 2
    block = plan.rows * plan.d_kernel * 2
    # pass 1: Q, dO, K ring, V ring on 1024-byte boundaries, then windows
    assert all(off % 1024 == 0 for off in plan.dq_offsets[:5])
    assert np.diff(plan.dq_offsets).tolist()[:4] == [
        block, block, plan.stages * tile, plan.stages * tile]
    # pass 2: K, V, Q ring, dO ring, statistics ring, byte tiles
    assert all(off % 1024 == 0 for off in plan.dkv_offsets[:5])
    assert plan.dkv_offsets[5] % 128 == 0 and plan.dkv_offsets[6] % 8 == 0
    assert np.diff(plan.dkv_offsets).tolist()[:6] == [
        block, block, plan.stages * tile, plan.stages * tile,
        plan.stages * 2 * 64 * 4, plan.rows // 64 * 2 * plan.nq * 80]
    assert plan.tmap_dims == ((plan.d_kernel, h, n, b) if layout == "bnhd"
                              else (plan.d_kernel, n, h, b))


def test_flash_bwd_plan_at_the_flagship():
    """Batch 1 (Grad-CAM) takes 64-row blocks, batch 8 and up 128; at
    D = 128 with two consumers pass 1 needs 171 KiB, pass 2 (32-query
    sub-tiles) 173 KiB."""
    p1 = fa.flash_bwd_plan(1, 1001, 8, 64, "bhnd")
    p8 = fa.flash_bwd_plan(8, 1001, 8, 64, "bnhd")
    assert (p1.rows, p1.grid) == (64, (16, 8))
    assert (p8.rows, p8.grid, p8.nq) == (128, (8, 64), 64)
    big = fa.flash_bwd_plan(8, 1001, 8, 128, "bnhd")
    assert big.dq_smem == 1024 + 2 * 128 * 128 * 2 + 2 * 3 * 64 * 128 * 2 \
        + 128 * 80 + 7 * 8
    assert big.dkv_smem == 1024 + 2 * 128 * 128 * 2 + 2 * 3 * 64 * 128 * 2 \
        + 3 * 512 + 2 * 2 * 32 * 80 + 7 * 8


def test_flash_bwd_plan_refuses():
    with pytest.raises(ValueError, match="head dim <= 128"):
        fa.flash_bwd_plan(1, 10, 1, 160, "bnhd")
    with pytest.raises(ValueError, match="layout"):
        fa.flash_bwd_plan(1, 10, 1, 64, "nbhd")
    with pytest.raises(ValueError, match="2\\^31"):
        fa.flash_bwd_plan(2 ** 20, 1001, 8, 64, "bnhd")
    with pytest.raises(ValueError, match="2\\^31"):
        fa.flash_fwd_plan(2 ** 20, 1001, 8, 64, "bhnd")
    # B * H past a grid's y plans, on the one-dimensional grid.
    assert fa.flash_bwd_plan(8193, 16, 8, 16, "bhnd").grid == (1, 65544)


@pytest.mark.parametrize("d", [16, 32, 80])
def test_backward_zero_pad_leaves_the_function(d):
    """Head dims 16 and 32 reach the backward padded to 64, 80 to 128: the
    plain backward on the padded operands gives the same dq, dk, dv (and
    zeros past d), bit for bit."""
    rng = np.random.default_rng(d + 3)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, 70, 3, d)),
                                dtype=torch.bfloat16) for _ in range(4))
    kw = dict(scale=d ** -0.5, n_valid=61, dropout_rate=0.1, seed=5)
    o, lsum = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lsum, **kw)
    pad = fa.flash_bwd_plan(2, 70, 3, d, "bnhd").d_kernel
    got_p = fa.flash_attention_bwd_plain(
        *(fa.pad_head_dim(t, pad) for t in (q, k, v, o, do)), lsum, **kw)
    for g, g_p in zip(got, got_p):
        assert torch.all(g_p[..., d:] == 0)
        assert torch.equal(g_p[..., :d], g)


# ---------------------------------------------------------------------------
# The numpy models of pass 2's accumulators and byte tile.
# ---------------------------------------------------------------------------

T = np.arange(128)
QUAD = T % 4
R0 = 16 * (T // 32) + (T % 32) // 4


def _acc_positions(nq: int):
    """(key row, query column) of d[4 j + i] for every thread of an
    m64n{nq} accumulator: two [128, nq / 2] arrays."""
    idx = np.arange(nq // 2)
    j, i = idx // 4, idx % 4
    keys = R0[:, None] + 8 * (i // 2)[None, :]
    queries = 8 * j[None, :] + 2 * QUAD[:, None] + (i % 2)[None, :]
    return keys, queries


@pytest.mark.parametrize("nq", [32, 64])
def test_transposed_accumulator_covers_the_sub_tile_once(nq):
    keys, queries = _acc_positions(nq)
    cells = keys * nq + queries
    assert np.array_equal(np.sort(cells.ravel()), np.arange(64 * nq))


@pytest.mark.parametrize("nq", [32, 64])
def test_transposed_pairs_are_the_a_operand_of_each_k16_chunk(nq):
    """pm[2 j + R] = (d[4 j + 2 R], d[4 j + 2 R + 1]) of S^T's or dP^T's
    accumulator; chunk c's A operand is pm[4 c .. 4 c + 3], which wgmma
    reads as key rows (r, r + 8, r, r + 8) and query columns 16 c + (c0,
    c0, c0 + 8, c0 + 8) + {0, 1}, c0 = 2 (t % 4): the k16 A fragment of
    (P^T m)[64 keys, 16 queries], whose B is rows 16 c .. 16 c + 15 of the
    MN-major dO (or Q) sub-tile."""
    keys, queries = _acc_positions(nq)
    for c in range(nq // 16):
        for reg in range(4):
            pair = 4 * c + reg
            j, R = pair // 2, pair % 2
            for e in range(2):
                idx = 4 * j + 2 * R + e
                want_key = R0 + 8 * (reg % 2)
                want_query = 16 * c + 2 * QUAD + 8 * (reg // 2) + e
                assert np.array_equal(keys[:, idx], want_key)
                assert np.array_equal(queries[:, idx], want_query)


def _words(blocks: np.ndarray, seed: int) -> np.ndarray:
    """Philox4x32-10 of each block index under ``seed``, as 16 bytes."""
    w = nn.philox4x32(torch.tensor(blocks.ravel(), dtype=torch.int64),
                      seed).numpy().astype(np.uint64)
    b = (w[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    return b.reshape(blocks.shape + (16,)).astype(np.uint8)


def _byte_tile_model(bh, n, n_valid, h_total, b_total, kw, nq, seed, rate):
    """Run pass 2's byte tile for one consumer warpgroup (keys kw .. kw +
    63 of head bh) over every sub-tile of queries: the blocks each thread
    computes into the tile, then the keep decisions each thread reads at
    its (key, query) positions; and the same from ``nn.keep_mask`` of the
    whole [B, H, N, N] tensor. Positions past N, and keys at or past
    n_valid (p = 0 there, so their bits are never used), are left out."""
    q_keep, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (b_total, h_total, n, n), rate).reshape(
        b_total * h_total, n, n).numpy()
    keys, cols = _acc_positions(nq)
    row0 = bh * n
    got, want, calls = [], [], np.zeros(128, dtype=int)
    for u in range(-(-n // 64) * (64 // nq)):
        qbase = (u // (64 // nq)) * 64 + (u % (64 // nq)) * nq
        tile = np.full((nq, 80), -1, dtype=np.int16)
        # The kernel's loop: thread t computes blocks t, t + 128, ...
        blk = np.arange(nq * 5)
        c, slot = blk // 5, blk % 5
        i0 = (row0 + qbase + c).astype(np.int64) * n + kw
        tile[c[:, None], 16 * slot[:, None] + np.arange(16)] = _words(
            (i0 >> 4) + slot, seed)
        calls += np.bincount(blk % 128, minlength=128)
        assert (tile >= 0).all()
        # A thread's offset into a row's window, from the low 32 bits.
        row_lo = (row0 + qbase) & 0xFFFFFFFF
        off = (((row_lo + cols) * n + kw) & 0xFFFFFFFF) & 15
        i0 = (row0 + qbase + cols).astype(np.int64) * n + kw
        assert np.array_equal(off, i0 & 15)
        byte = tile[cols, off + keys]
        q_idx, k_idx = qbase + cols, kw + keys
        ok = (q_idx < n) & (k_idx < n_valid)
        ref = np.zeros_like(ok)
        ref[ok] = mask[bh, q_idx[ok], k_idx[ok]]
        got.append((byte < q_keep) & ok)
        want.append(ref)
    return np.array(got), np.array(want), calls


@pytest.mark.parametrize("nq", [32, 64])
@pytest.mark.parametrize("n,n_valid,kw,bh", [
    (64, 64, 0, 0), (130, 129, 64, 3), (130, 65, 64, 1), (130, 130, 128, 1),
    (1001, 1001, 896, 5), (1001, 900, 896, 2), (1001, 961, 960, 4)])
def test_byte_tile_gives_keep_mask_bits(n, n_valid, kw, bh, nq):
    got, want, calls = _byte_tile_model(bh, n, n_valid, 3, 2, kw, nq,
                                        seed=4321, rate=0.1)
    assert got.shape[0] == -(-n // 64) * (64 // nq)
    assert np.array_equal(got, want)
    assert want.any() and not want.all()
    # 5 nq Philox calls a sub-tile over 128 threads: 2.5 a thread at 64.
    units = got.shape[0]
    assert calls.sum() == units * 5 * nq
    assert calls.max() <= units * -(-5 * nq // 128)


def test_byte_tile_offsets_past_2_to_the_32():
    """The row's byte offset from the 32-bit low word of its index holds
    where the index passes 2^32: B * H = 65 544 heads of 1001 x 1001."""
    n, kw = 1001, 960
    for bh in (4290, 65543):
        row0 = bh * n
        qbase = 960
        cols = np.arange(64)
        i0 = (row0 + qbase + cols).astype(np.int64) * n + kw
        assert i0.max() > 2 ** 32 or bh == 4290
        row_lo = (row0 + qbase) & 0xFFFFFFFF
        off = (((row_lo + cols) * n + kw) & 0xFFFFFFFF) & 15
        assert np.array_equal(off, i0 & 15)
