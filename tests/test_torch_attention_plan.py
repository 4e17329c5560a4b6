"""The attention forward's launch plan (``ops/flash_attention.py``
``flash_fwd_plan``) as a pure function, and a numpy model of how the kernel
(``csrc/flash_attention.cu``) lays scores and dropout bits over its threads.

The plan, at the flagship (batch 1, 8, 32, 128 x 1001 tokens, 8 heads of
64), at every width of ``models/vit3d.py`` WIDTHS and at the card tests'
shapes: the forward instance D (64 or 128), 128-row blocks where the grid
fills the card's 132 SMs and 64-row blocks where it would not, 64-key
tiles, a grid of (q tiles, B * H) that covers N with no spare tile, shared
memory within the H100's 227 KiB with every tile on a 1024-byte boundary,
and the tensor maps' dims ordered by the layout. The card tests hold the
plan's bytes and block rows to the kernel's own.

The model: thread t of a consumer warpgroup holds the S accumulator's
d[4 j + i] at row 16 (t / 32) + (t % 32) / 4 + 8 (i / 2), key 8 j + 2 (t %
4) + i % 2 (wgmma's m64n64 layout); its bf16 pairs, four per k16 chunk, are
the A operand of P . V. For dropout the four threads of a quad share the
Philox blocks of their two rows through an 80-byte window per row: thread
t % 4 computes block t % 4 + 1 of the window, thread 3 carries the last
block into the next tile's first. The model runs that exchange tile by tile
and checks that every thread reads, at every position it holds, the byte
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
# tests/test_torch_cuda.py's forward cases: head dims, token counts, and
# (B, H) under and over the card's 132 SMs.
CARD_SHAPES = ([(1, n, 2, d) for d in (16, 32, 64, 80, 128)
                for n in (64, 130, 1001)]
               + [(1, 1001, 8, 64), (8, 1001, 8, 64), (3, 130, 11, 64),
                  (40, 130, 4, 128), (1, 1, 3, 64), (2, 70, 3, 64)])
SHAPES = FLAGSHIP + WIDTH_SHAPES + CARD_SHAPES


@pytest.mark.parametrize("layout", fa.LAYOUTS)
@pytest.mark.parametrize("b,n,h,d", SHAPES)
def test_flash_fwd_plan(b, n, h, d, layout):
    plan = fa.flash_fwd_plan(b, n, h, d, layout)
    assert plan.d_kernel == (64 if d <= 64 else 128)
    assert plan.d_kernel >= fa.kernel_head_dim(d)
    fills = b * h * -(-n // 128) >= 132
    assert plan.bq == (128 if fills else 64)
    assert plan.bkv == 64 and plan.stages >= 2
    q_tiles, heads = plan.grid
    assert heads == b * h
    assert (q_tiles - 1) * plan.bq < n <= q_tiles * plan.bq
    assert plan.smem <= SMEM_LIMIT
    assert all(off % 1024 == 0 for off in plan.offsets[:4])
    assert plan.offsets[4] % 8 == 0
    tile = 64 * plan.d_kernel * 2
    assert plan.offsets[1] == plan.bq * plan.d_kernel * 2
    assert plan.offsets[2] - plan.offsets[1] == plan.stages * tile
    assert plan.offsets[3] - plan.offsets[2] == plan.stages * tile
    assert plan.tmap_dims == ((plan.d_kernel, h, n, b) if layout == "bnhd"
                              else (plan.d_kernel, n, h, b))


def test_flash_fwd_plan_at_the_flagship():
    """Batch 1 (Grad-CAM at one volume) takes 64-row blocks: 8 heads x 8
    tiles of 128 would fill 64 of 132 SMs; batch 8 and up take 128."""
    grids = {b: fa.flash_fwd_plan(b, 1001, 8, 64, "bhnd") for b in (1, 8)}
    assert (grids[1].bq, grids[1].grid) == (64, (16, 8))
    assert (grids[8].bq, grids[8].grid) == (128, (8, 64))
    assert fa.flash_fwd_plan(128, 1001, 8, 64, "bnhd").grid == (8, 1024)
    # 64-row blocks at D = 128: Q 16 KiB, three stages of 16 KiB K and V.
    assert fa.flash_fwd_plan(1, 1001, 8, 128, "bnhd").smem == (
        1024 + 64 * 128 * 2 + 2 * 3 * 64 * 128 * 2 + 64 * 80 + 7 * 8)


@pytest.mark.parametrize("d,want", [(8, 64), (16, 64), (17, 64), (32, 64),
                                    (33, 64), (64, 64), (65, 128), (80, 128),
                                    (128, 128)])
def test_fwd_head_dim(d, want):
    assert fa.fwd_head_dim(d) == want
    assert fa.kernel_head_dim(d) <= want


def test_flash_fwd_plan_refuses():
    with pytest.raises(ValueError, match="head dim <= 128"):
        fa.flash_fwd_plan(1, 10, 1, 160, "bnhd")
    # B * H is no longer bounded by a grid's y (65535): 70 000 plans, on
    # the one-dimensional grid.
    plan = fa.flash_fwd_plan(70000, 10, 1, 64, "bnhd")
    assert plan.grid == (1, 70000)
    with pytest.raises(ValueError, match="layout"):
        fa.flash_fwd_plan(1, 10, 1, 64, "nbhd")


@pytest.mark.parametrize("d", [16, 32])
def test_forward_zero_pad_to_64_leaves_the_function(d):
    """D = 16 and 32 reach the forward padded to 64: the plain forward on
    the padded operands gives the same o (and zeros past d) and the same
    row sums, bit for bit."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.standard_normal((2, 70, 3, d)),
                            dtype=torch.bfloat16) for _ in range(3))
    kw = dict(scale=d ** -0.5, n_valid=61, dropout_rate=0.1, seed=5,
              layout="bnhd")
    o, lsum = fa._fwd_plain(q, k, v, **kw)
    o_p, lsum_p = fa._fwd_plain(*(fa.pad_head_dim(t, fa.fwd_head_dim(d))
                                  for t in (q, k, v)), **kw)
    assert torch.all(o_p[..., d:] == 0)
    assert torch.equal(o_p[..., :d], o) and torch.equal(lsum_p, lsum)


# ---------------------------------------------------------------------------
# The numpy model of the accumulator and the quad's Philox exchange.
# ---------------------------------------------------------------------------

T = np.arange(128)
QUAD = T % 4
R0 = 16 * (T // 32) + (T % 32) // 4


def _acc_positions():
    """(row, key) of d[4 j + i] for every thread: two [128, 32] arrays."""
    idx = np.arange(32)
    j, i = idx // 4, idx % 4
    rows = R0[:, None] + 8 * (i // 2)[None, :]
    keys = 8 * j[None, :] + 2 * QUAD[:, None] + (i % 2)[None, :]
    return rows, keys


def test_accumulator_covers_the_tile_once():
    rows, keys = _acc_positions()
    cells = rows * 64 + keys
    assert np.array_equal(np.sort(cells.ravel()), np.arange(64 * 64))


def test_p_pairs_are_the_a_operand_of_each_k16_chunk():
    """pa[2 j + R] = (d[4 j + 2 R], d[4 j + 2 R + 1]); chunk c's A operand
    is pa[4 c .. 4 c + 3], which wgmma reads as rows (r, r + 8, r, r + 8)
    and key columns 16 c + (c0, c0, c0 + 8, c0 + 8) + {0, 1}, c0 = 2 (t %
    4): the k16 A fragment."""
    rows, keys = _acc_positions()
    for c in range(4):
        for reg in range(4):
            pair = 4 * c + reg
            j, R = pair // 2, pair % 2
            for e in range(2):
                idx = 4 * j + 2 * R + e
                want_row = R0 + 8 * (reg % 2)
                want_key = 16 * c + 2 * QUAD + 8 * (reg // 2) + e
                assert np.array_equal(rows[:, idx], want_row)
                assert np.array_equal(keys[:, idx], want_key)


def _words(blocks: np.ndarray, seed: int) -> np.ndarray:
    """Philox4x32-10 of each block index under ``seed``, as 16 bytes."""
    w = nn.philox4x32(torch.tensor(blocks.ravel(), dtype=torch.int64),
                      seed).numpy().astype(np.uint64)
    b = (w[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    return b.reshape(blocks.shape + (16,)).astype(np.uint8)


def _exchange_model(bh, n, h_total, b_total, qw, n_valid, seed, rate):
    """Run the kernel's per-quad exchange for one consumer warpgroup
    (rows qw .. qw + 63 of head bh) over every key tile; return, per tile,
    the keep decisions each thread makes at each of its 32 positions, and
    the same from ``nn.keep_mask`` of the whole [B, H, N, N] tensor."""
    q_keep, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (b_total, h_total, n, n), rate).reshape(
        b_total * h_total, n, n).numpy()
    rows, keys = _acc_positions()
    i0 = [(bh * n + (qw + R0 + 8 * R)).astype(np.int64) * n for R in (0, 1)]
    blk0 = [x >> 4 for x in i0]
    off = [x & 15 for x in i0]
    carry = [_words(blk0[R], seed) for R in (0, 1)]   # held by quad 3
    got, want = [], []
    for t in range(-(-n_valid // 64)):
        window = np.zeros((2, 128, 80), dtype=np.int16) - 1
        for R in (0, 1):
            w = _words(blk0[R] + 4 * t + QUAD + 1, seed)
            # Each row's window lives once, shared by its quad: a thread
            # writes slot quad + 1, quad 3 also slot 0 (the carry).
            for slot in range(5):
                writer = QUAD == (slot - 1 if slot else 3)
                words = w if slot else carry[R]
                for quad_base in range(0, 128, 4):
                    src = quad_base + np.flatnonzero(writer[quad_base:
                                                            quad_base + 4])
                    assert len(src) == 1
                    window[R, quad_base:quad_base + 4,
                           16 * slot:16 * slot + 16] = words[src[0]]
            carry[R] = np.where((QUAD == 3)[:, None], w, carry[R])
        assert (window >= 0).all()
        byte = np.empty((128, 32), dtype=np.int64)
        for idx in range(32):
            R = (idx % 4) // 2
            byte[:, idx] = window[R, T, off[R] + keys[:, idx]]
        got.append(byte < q_keep)
        q_rows = qw + rows
        ok = q_rows < n
        ref = np.zeros((128, 32), dtype=bool)
        ref[ok] = mask[bh, q_rows[ok], (64 * t + keys)[ok] % n]
        got[-1] = np.where(ok, got[-1], False)
        want.append(ref)
        in_range = (64 * t + keys) < n
        got[-1] &= in_range
        want[-1] &= in_range
    return np.array(got), np.array(want)


@pytest.mark.parametrize("n,n_valid,qw,bh", [(64, 64, 0, 0), (130, 129, 64, 3),
                                             (130, 65, 0, 1),
                                             (1001, 1001, 896, 5),
                                             (1001, 900, 384, 2)])
def test_quad_philox_exchange_gives_keep_mask_bits(n, n_valid, qw, bh):
    got, want = _exchange_model(bh, n, 3, 2, qw, n_valid, seed=1234,
                                rate=0.1)
    assert got.shape[0] == -(-n_valid // 64)
    assert np.array_equal(got, want)
    assert want.any() and not want.all()


def test_quad_philox_exchange_calls():
    """Two Philox blocks per thread per tile (one per row), against the
    four or five of each row a thread would compute on its own: its 16 keys
    of a row, 8 j + 2 (t % 4) + {0, 1}, touch four or five of the row's
    window's blocks (9.1 a tile on average over the flagship's rows)."""
    n = 1001
    calls = []
    for row in range(64):
        i0 = row * n
        window = {(i0 + k) >> 4 for k in range(64)}
        assert len(window) == (5 if i0 % 16 else 4)
        for quad in range(4):
            keys = (8 * np.arange(8)[:, None] + np.array([0, 1])[None, :]
                    + 2 * quad).ravel()
            own = {int(x) for x in (i0 + keys) >> 4}
            assert own <= window
            calls.append(len(own))
    assert min(calls) == 4 and max(calls) == 5
    assert 2 * np.mean(calls) > 4 * 2
