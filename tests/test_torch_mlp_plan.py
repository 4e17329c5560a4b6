"""K4, the bf16 residual MLP forward on TMA + wgmma: its launch plan as a
pure function, and a numpy model of how its GEMM epilogues share the
dropout bits within a quad.

(a) ``mlp_plan`` (ops/fused_mlp.py): three launches -- the LN rows, fc1 +
GELU, fc2 + residual -- with grids that cover the rows and columns with no
spare tile, 128-column GEMM tiles, or 64 where 128 would give the card's
132 SMs fewer blocks, GEMM blocks whose shared memory is the Mainloop's
count (csrc/hopper_gemm.cuh: the 1 KiB alignment slack, three stages of a
128 x 128-byte A box and a tile x 128-byte Bt box, a full and an empty
barrier a stage) and of which two fit an H100 SM, with room in the ring
for fc1's staged output tiles (g and h), and the scratch -- u, then g,
both bf16 -- on 256-byte boundaries. Every entry of models/vit3d.py
WIDTHS and the two widths the earlier wmma kernel refused (dim 1024 / mlp
8192, ViT-H's 1280 / 5120), at one row, a ragged 130, one volume (1001)
and the flagship's batch 8 (8008). The card test holds the plan's bytes to
the kernel's own count.

(b) The model: thread t of a consumer warpgroup holds the accumulator's
d[4 j + i] at row 16 (t / 32) + (t % 32) / 4 + 8 (i / 2), column 8 j + 2
(t % 4) + i % 2 of its warpgroup's 64-row part of the tile (wgmma's
m64nN layout). For dropout, thread o of each quad draws Philox blocks
2 o and 2 o + 1 of a row's 128 columns from the tile's first, packs their
keep bits into one word, and every thread of the quad reads the four words
by shuffle. The model runs that exchange for whole tiles, 128 and 64
columns wide, at the fc1 site (row * hid + j) and the fc2 site (row * dim
+ c), ragged edges included, and checks that each thread's keep decision
at each of its positions is the bit ``nn.keep_mask`` gives there.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import fused_mlp
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

OPEN_WIDTHS = {"mlp8192": (1024, 8192), "vit_h": (1280, 5120)}
PLAN_WIDTHS = {**{name: (w[0], w[3]) for name, w in WIDTHS.items()},
               **OPEN_WIDTHS}
ROWS = [1, 130, 1001, 8008]


def _gemm_smem(tile_n):
    """csrc/hopper_gemm.cuh, Mainloop<false, 128, tile_n, 3>::kSmemBytes."""
    return 1024 + 3 * (128 * 128 + tile_n * 128) + 2 * 3 * 8


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_mlp_plan(width, m):
    dim, hid = PLAN_WIDTHS[width]
    plan = fused_mlp.mlp_plan(m, dim, hid)
    names = [launch[0] for launch in plan.launches]
    assert names == ["ln_rows", "fc1_gelu", "fc2_residual"]
    grids = {name: grid for name, grid, _, _ in plan.launches}
    tile, rows = fused_mlp.MLP_TILE, fused_mlp.ROW_WARPS
    gx, gy = grids["ln_rows"]          # one warp a row, ROW_WARPS a block
    assert gy == 1 and (gx - 1) * rows < m <= gx * rows
    smem = {name: s for name, _, _, s in plan.launches}
    assert smem["ln_rows"] == 0
    for name, n in (("fc1_gelu", hid), ("fc2_residual", dim)):
        nt, mt = grids[name]           # (column tiles, row tiles)
        assert (mt - 1) * tile < m <= mt * tile
        full = -(-n // tile) * mt      # blocks at 128-column tiles
        tile_n = 64 if full < 132 else 128
        assert (nt - 1) * tile_n < n <= nt * tile_n
        assert smem[name] == _gemm_smem(tile_n)
        # Two GEMM blocks (each with the 1 KiB the card reserves) fit the
        # SM's 228 KiB, one fits a block's limit, and the ring (past the
        # slack and before the barriers) holds two staged bf16 output
        # tiles of 128 x tile_n.
        assert 2 * (smem[name] + 1024) <= 228 * 1024
        assert smem[name] <= SMEM_LIMIT
        assert smem[name] - 1024 - 48 >= 2 * 128 * tile_n * 2
    threads = {name: t for name, _, t, _ in plan.launches}
    assert threads == {"ln_rows": 256, "fc1_gelu": 288, "fc2_residual": 288}
    want = {"u": m * dim * 2, "g": m * hid * 2}
    assert list(plan.scratch) == list(want)
    end = 0
    for name, (offset, nbytes) in plan.scratch.items():
        assert nbytes == want[name]
        assert offset % fused_mlp.SCRATCH_ALIGN == 0 and offset >= end
        assert offset - end < fused_mlp.SCRATCH_ALIGN
        end = offset + nbytes
    assert plan.scratch["u"][0] == 0
    assert end <= plan.scratch_bytes < end + fused_mlp.SCRATCH_ALIGN


def test_mlp_plan_at_the_flagship():
    """Batch 8: 63 row tiles, 16 x 63 fc1 blocks and 8 x 63 fc2 blocks of
    128 x 128; u (16.4 MB) and g (32.8 MB) in one 49.2 MB scratch. One
    volume: 8 row tiles, where 128-column tiles would make 128 and 64
    blocks, take 64-column tiles (256 and 128 blocks)."""
    plan = fused_mlp.mlp_plan(8 * 1001, 1024, 2048)
    assert [grid for _, grid, _, _ in plan.launches] == [
        (1001, 1), (16, 63), (8, 63)]
    assert [s for *_, s in plan.launches] == [0, 99376, 99376]
    assert plan.scratch == {"u": (0, 16400384), "g": (16400384, 32800768)}
    assert plan.scratch_bytes == 49201152
    one = fused_mlp.mlp_plan(1001, 1024, 2048)
    assert [grid for _, grid, _, _ in one.launches] == [
        (126, 1), (32, 8), (16, 8)]
    assert [s for *_, s in one.launches] == [0, 74800, 74800]
    # 132 blocks and more keep 128-column tiles: 17 row tiles x 8 = 136.
    assert fused_mlp.mlp_plan(17 * 128, 1024, 2048).launches[2][1] == (8, 17)
    assert fused_mlp.mlp_plan(16 * 128, 1024, 2048).launches[2][1] == (16, 16)


@pytest.mark.parametrize("dim,hid,match", [
    (1024, 8192, None), (1280, 5120, None), (2048, 16384, None),
    (16, 16, None), (1000, 4096, "dim as a multiple of 16"),
    (1024, 2056, "mlp_dim as a multiple of 16"),
    (8, 128, "dim as a multiple of 16")])
def test_check_fwd_shapes(dim, hid, match):
    """No shared-memory refusal is left; a width off 16 (or below it) is
    still refused and names the queue."""
    if match is None:
        fused_mlp.check_fwd_shapes(dim, hid)
        fused_mlp.mlp_plan(3, dim, hid)
        return
    for gate in (fused_mlp.check_fwd_shapes,
                 lambda d, h: fused_mlp.mlp_plan(3, d, h)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, hid)
        assert "ROADMAP.md, Queue 3" in str(err.value)


def test_mlp_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        fused_mlp.mlp_plan(0, 1024, 2048)


# ---------------------------------------------------------------------------
# The numpy model of the epilogue's quad Philox exchange.
# ---------------------------------------------------------------------------

T = np.arange(256)                      # the two consumer warpgroups
QUAD = T % 4
R0 = 64 * (T // 128) + 16 * ((T % 128) // 32) + (T % 32) // 4
LANE_BASE = T & ~3                      # the quad's first thread


def _blocks(blk: np.ndarray, seed: int) -> np.ndarray:
    """Philox4x32-10 of each block index under ``seed``: [..., 4] words."""
    w = nn.philox4x32(torch.tensor(blk.ravel(), dtype=torch.int64),
                      seed).numpy().astype(np.uint64)
    return w.reshape(blk.shape + (4,))


def _vcmpltu4_low_bits(word: np.ndarray, q: int) -> np.ndarray:
    """__vcmpltu4(word, q * 0x01010101) & 0x01010101: bit 8 p where byte p
    of the word is below q."""
    out = np.zeros_like(word)
    for p in range(4):
        byte = (word >> np.uint64(8 * p)) & np.uint64(0xFF)
        out |= np.where(byte < q, np.uint64(1) << np.uint64(8 * p),
                        np.uint64(0))
    return out


def _tile_keep(m0: int, n0: int, width: int, seed: int, q: int,
               tile_n: int):
    """Each thread's keep decision at its positions of the 128 x tile_n
    tile at (m0, n0) of an [M, width] site: [256, 2 (half), tile_n / 8
    (j), 2 (e)], as the kernel's QuadKeep computes it, with (rows, cols) of
    each."""
    groups = tile_n // 8
    got = np.zeros((256, 2, groups, 2), dtype=bool)
    rows = np.zeros((256, 2), dtype=np.int64)
    for half in range(2):
        row = m0 + R0 + 8 * half
        rows[:, half] = row
        blk0 = (row.astype(np.int64) * width + n0) >> 4
        mine = np.zeros(256, dtype=np.uint64)
        for k in range(2):
            words = _blocks(blk0 + 2 * QUAD + k, seed)
            for i in range(4):
                mine |= _vcmpltu4_low_bits(words[:, i], q) << np.uint64(
                    4 * k + i)
        shift = (16 * (QUAD % 2) + QUAD // 2).astype(np.uint64)
        word = np.stack([mine[LANE_BASE + o] >> shift for o in range(4)], 1)
        for j in range(groups):
            for e in range(2):
                bit = np.uint64(8 * e + 4 * ((j // 2) % 2) + 2 * (j % 2))
                got[:, half, j, e] = (word[:, j // 4] >> bit) & np.uint64(1)
    cols = (n0 + 8 * np.arange(groups)[None, :, None]
            + 2 * QUAD[:, None, None] + np.arange(2)[None, None, :])
    return got, rows, cols


@pytest.mark.parametrize("tile_n", [128, 64])
@pytest.mark.parametrize("site", ["fc1", "fc2"])
@pytest.mark.parametrize("m,dim,hid", [(130, 256, 384), (300, 64, 128),
                                       (1001, 1024, 2048), (40, 1280, 5120)])
def test_quad_keep_bits_are_keep_mask_bits(site, m, dim, hid, tile_n):
    """Every tile of the site, the ragged last row and column tiles
    included: at every position inside [m, width] each thread's bit is
    nn.keep_mask's, and each position of the site is held by exactly one
    thread of one tile."""
    width, seed, rate = (hid, 77, 0.1) if site == "fc1" else (dim, 78, 0.1)
    q, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (m, width), rate).numpy()
    seen = np.zeros((m, width), dtype=np.int64)
    for m0 in range(0, m, 128):
        for n0 in range(0, width, tile_n):
            got, rows, cols = _tile_keep(m0, n0, width, seed, q, tile_n)
            r = np.broadcast_to(rows[:, :, None, None], got.shape)
            c = np.broadcast_to(cols[:, None, :, :], got.shape)
            inside = (r < m) & (c < width)
            assert np.array_equal(got[inside], mask[r[inside], c[inside]])
            np.add.at(seen, (r[inside], c[inside]), 1)
    assert (seen == 1).all()
    assert mask.any() and not mask.all()


def test_quad_keep_draws_each_block_once():
    """Two Philox blocks a thread a row of the tile, eight a quad: the
    row's 128 columns are eight 16-byte blocks, each drawn by one thread,
    against the eight a thread would draw alone (its 32 columns of a row
    touch every block of the row's tile)."""
    drawn = {}
    for t in range(4):
        for k in range(2):
            drawn.setdefault(2 * t + k, []).append(t)
    assert sorted(drawn) == list(range(8))
    assert all(len(v) == 1 for v in drawn.values())
    touched = {(8 * j + 2 * t + e) // 16 for j in range(16) for e in range(2)
               for t in (0,)}
    assert touched == set(range(8))
