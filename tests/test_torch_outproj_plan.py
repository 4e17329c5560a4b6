"""K3 and K11, the bf16 and int8 out-projections, and K8, the bf16
out-projection's backward, as launch plans: ``outproj_plan`` and
``outproj_bwd_plan`` (ops/fused_outproj.py) and ``int8_outproj_plan``
(ops/int8_serving.py) as pure functions.

K3 is one launch of K4's fc2_residual pass; K11 is two, the row quantizer
(without the LayerNorm) and K12's fc2_residual pass. Their grids cover the
rows and dim's columns, their GEMM blocks fit two to an H100 SM's shared
memory, their tiles are 64 columns wide exactly where 128-wide tiles would
give the card's 132 SMs fewer blocks, and K11's scratch holds a8 and the
row scales in order on 256-byte boundaries. At the flagship at batch 1, 8
and 32, one row, ragged 65 and 130, one full tile, every entry of
models/vit3d.py WIDTHS, ViT-H (1280, 16 heads of 80) and dim / inner 1536
and 2048. Widths off 16 and fewer than one row are refused; no width
limit is left on either forward or on K8. K8 is K9's dz rows pass (at
dropout > 0 only) and a GEMM over inner's column tiles, also planned at an
inner that is not a multiple of 64 (1040). K3's dropout bits, drawn by the
quad in the wgmma layout, and K8's, drawn a Philox block a lane by its
dz rows pass, are nn.keep_mask's at the site (row * dim + col) on the
ragged 130-row tile at dim 1536 and 2048. The card test holds the plans'
bytes against the kernels' own counts.
``scripts/torch_outproj_device_times.py``'s bounds are the functions' and
it refuses to run without the card.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import fused_outproj as k3
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT
from test_torch_mlp_plan import _blocks, _tile_keep

# name -> (dim, inner)
PLAN_WIDTHS = {**{name: (w[0], w[1] * w[2]) for name, w in WIDTHS.items()},
               "vit_h": (1280, 1280), "dim1536": (1536, 1536),
               "dim2048": (2048, 2048)}
# K8's widths also take an inner that is not a multiple of 64: the last
# column tile's second 64-column box lies past inner.
BWD_WIDTHS = {**PLAN_WIDTHS, "inner1040": (1024, 1040)}
# The flagship at batch 1, 8 and 32 (x 1001 tokens), one row, the card
# tests' ragged 65 and 130, and one full 128-row tile.
ROWS = [1001, 8008, 32032, 1, 65, 130, 128]
SMS = 132
TILE = 128
GEMM_THREADS = 2 * 128 + 32     # two consumer warpgroups and the producer


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_smem(tile_n: int) -> int:
    """csrc/hopper_gemm.cuh, Mainloop<kInt8, 128, tile_n, 3>::kSmemBytes
    (either operand type: a box is 128 bytes of K): the 1 KiB alignment
    slack, three stages of a 128 x 128-byte A box and a tile_n x 128-byte
    Bt box, and a full and an empty barrier a stage."""
    return 1024 + 3 * (TILE + tile_n) * 128 + 2 * 3 * 8


def _check_gemm(launch, m: int, dim: int) -> int:
    """The fc2_residual launch of either plan; returns its tile width."""
    name, (gx, gy), threads, smem = launch
    assert name == "fc2_residual"
    wide = _ceil(dim, TILE) * _ceil(m, TILE)
    tile_n = 64 if wide < SMS else TILE
    assert (gx, gy) == (_ceil(dim, tile_n), _ceil(m, TILE))
    assert threads == GEMM_THREADS
    assert smem == _gemm_smem(tile_n) <= SMEM_LIMIT
    assert 2 * (smem + 1024) <= 228 * 1024       # two blocks an SM
    return tile_n


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_outproj_plan(width, m):
    dim, inner = PLAN_WIDTHS[width]
    k3.check_fwd_shapes(dim, inner)
    plan = k3.outproj_plan(m, dim, inner)
    assert len(plan.launches) == 1
    assert plan.tile_n == _check_gemm(plan.launches[0], m, dim)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_int8_outproj_plan(width, m):
    dim, inner = PLAN_WIDTHS[width]
    q8.check_outproj_shapes(dim, inner)
    plan = q8.int8_outproj_plan(m, dim, inner)
    assert [launch[0] for launch in plan.launches] == ["rowquant",
                                                        "fc2_residual"]
    # The row pass: one warp a row, eight rows a block, no shared memory.
    _, (rx, ry), r_threads, r_smem = plan.launches[0]
    assert ry == 1 and (rx - 1) * 8 < m <= rx * 8
    assert r_threads == 256 and r_smem == 0
    assert plan.tile_n == _check_gemm(plan.launches[1], m, dim)
    # The scratch: a8 [m, inner] int8, then s_row [m] f32.
    assert list(plan.scratch) == ["a8", "s_row"]
    assert plan.scratch["a8"] == (0, m * inner)
    offset, nbytes = plan.scratch["s_row"]
    assert nbytes == 4 * m and offset % 256 == 0
    assert m * inner <= offset < m * inner + 256
    assert offset + nbytes <= plan.scratch_bytes < offset + nbytes + 256
    assert plan.scratch_bytes % 256 == 0


def test_plans_at_the_flagship():
    """Batch 8: 8 x 63 full tiles; batch 1: 64-column tiles (8 x 8
    128-wide tiles would fill 64 of 132 SMs), 16 x 8; batch 32: 8 x 251.
    K11's scratch at batch 8: 8008 x 512 codes, then 8008 row scales."""
    for b, tile_n, grid in ((1, 64, (16, 8)), (8, 128, (8, 63)),
                            (32, 128, (8, 251))):
        bf = k3.outproj_plan(b * 1001, 1024, 512)
        i8 = q8.int8_outproj_plan(b * 1001, 1024, 512)
        assert bf.tile_n == i8.tile_n == tile_n
        assert bf.launches[0][1] == i8.launches[1][1] == grid
    plan = q8.int8_outproj_plan(8008, 1024, 512)
    assert plan.launches[0][1] == (1001, 1)
    assert plan.scratch_bytes == 8008 * 512 + 32256


@pytest.mark.parametrize("dim,inner,match", [
    (1024, 512, None), (1280, 1280, None), (1536, 1536, None),
    (2048, 2048, None), (64, 320, None), (1024, 4096, None),
    (1000, 512, "dim as a multiple of 16"),
    (1024, 1288, "inner as a multiple of 16"),
    (1024, 8, "inner as a multiple of 16"),
    (8, 64, "dim as a multiple of 16")])
def test_check_outproj_shapes(dim, inner, match):
    """No row-width or shared-memory refusal is left on either forward; a
    width off 16 (or below it) is still refused and names the queue."""
    gates = (k3.check_fwd_shapes, q8.check_outproj_shapes,
             lambda d, i: k3.outproj_plan(3, d, i),
             lambda d, i: q8.int8_outproj_plan(3, d, i))
    for gate in gates:
        if match is None:
            gate(dim, inner)
            continue
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, inner)
        assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("plan", [k3.outproj_plan, q8.int8_outproj_plan])
@pytest.mark.parametrize("m", [0, -1])
def test_outproj_plans_refuse_no_rows(plan, m):
    with pytest.raises(ValueError, match="at least one row"):
        plan(m, 1024, 512)


@pytest.mark.parametrize("dim,inner", [(1024, 512), (1536, 512),
                                       (2048, 512), (2048, 2048)])
def test_outproj_backward_keeps_its_gate(dim, inner):
    """K8's gate is the width gate alone: the wmma K8 held a 64-row block
    of dz beside its tiles and refused dim 2048 ("bytes of shared
    memory"); on K9's dz rows pass and the TMA + wgmma GEMM it takes dim
    2048 at any inner, and plans it: the GEMM over inner / 128 column
    tiles, no shared memory asked past two blocks an SM."""
    k3.check_bwd_shapes(dim, inner)
    plan = k3.outproj_bwd_plan(8008, dim, inner, 0.1)
    assert [name for name, *_ in plan.launches] == ["dz_rows", "dattn"]
    assert plan.launches[1][1] == (inner // 128, 63)
    assert plan.launches[1][3] == _gemm_smem(128)
    for gate in (k3.check_bwd_shapes,
                 lambda d, i: k3.outproj_bwd_plan(3, d, i, 0.1)):
        with pytest.raises(ValueError, match="dim as a multiple of 16"):
            gate(dim + 8, inner)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(BWD_WIDTHS))
def test_outproj_bwd_plan(width, m, rate):
    """K8: at dropout > 0 the dz rows pass (one warp a row, eight rows a
    block, no shared memory), then the dattn GEMM over (column tiles of
    inner, row tiles of 128) on K4's tiles, 64 columns wide exactly where
    128-wide tiles would give the card's 132 SMs fewer blocks; at dropout
    0 the GEMM alone, on dy."""
    dim, inner = BWD_WIDTHS[width]
    k3.check_bwd_shapes(dim, inner)
    plan = k3.outproj_bwd_plan(m, dim, inner, rate)
    names = [launch[0] for launch in plan.launches]
    assert names == (["dz_rows", "dattn"] if rate else ["dattn"])
    if rate:
        _, (rx, ry), r_threads, r_smem = plan.launches[0]
        assert ry == 1 and (rx - 1) * 8 < m <= rx * 8
        assert r_threads == 256 and r_smem == 0
    name, (gx, gy), threads, smem = plan.launches[-1]
    wide = _ceil(inner, TILE) * _ceil(m, TILE)
    assert plan.tile_n == (64 if wide < SMS else TILE)
    assert (gx, gy) == (_ceil(inner, plan.tile_n), _ceil(m, TILE))
    assert threads == GEMM_THREADS
    assert smem == _gemm_smem(plan.tile_n) <= SMEM_LIMIT
    assert 2 * (smem + 1024) <= 228 * 1024       # two blocks an SM


def test_outproj_bwd_plan_at_the_flagship():
    """Batch 1: 64-column tiles (4 x 8 128-wide tiles would fill 32 of
    132 SMs), 8 x 8; batch 8: 4 x 63 of 128; batch 32: 4 x 251. Inner 1040
    at batch 8: 9 column tiles of 128, the last holding 16 columns."""
    for b, tile_n, grid in ((1, 64, (8, 8)), (8, 128, (4, 63)),
                            (32, 128, (4, 251))):
        for rate in (0.0, 0.1):
            plan = k3.outproj_bwd_plan(b * 1001, 1024, 512, rate)
            assert plan.tile_n == tile_n
            assert plan.launches[-1][1] == grid
    plan = k3.outproj_bwd_plan(8008, 1024, 512, 0.1)
    assert plan.launches[0][1] == (1001, 1)
    assert k3.outproj_bwd_plan(8008, 1024, 1040, 0.1).launches[1][1] == (
        9, 63)


@pytest.mark.parametrize("dim,inner,match", [
    (1000, 512, "dim as a multiple of 16"),
    (1024, 1288, "inner as a multiple of 16"),
    (1024, 8, "inner as a multiple of 16"),
    (8, 64, "dim as a multiple of 16")])
def test_outproj_bwd_plan_refuses_widths_off_16(dim, inner, match):
    for rate in (0.0, 0.1):
        with pytest.raises(ValueError, match=match) as err:
            k3.outproj_bwd_plan(130, dim, inner, rate)
        assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("m", [0, -1])
def test_outproj_bwd_plan_refuses_no_rows(m):
    with pytest.raises(ValueError, match="at least one row"):
        k3.outproj_bwd_plan(m, 1024, 512, 0.1)


def _dz_rows_keep(m: int, dim: int, seed: int, q: int):
    """Each lane's keep decisions in K8's dz rows pass (K9's pass 1,
    csrc/fused_mlp.cu dz_rows_kernel): warp ``row``, lane l, step i take
    columns c = 512 i + 16 l .. + 15 (c < dim), element e being byte e % 4
    of word e / 4 of Philox block (row * dim + c) / 16. Returns [m, steps,
    32, 16] keep bits and the columns of each."""
    steps = _ceil(dim, 512)
    cols = (512 * np.arange(steps)[:, None, None]
            + 16 * np.arange(32)[None, :, None]
            + np.arange(16)[None, None, :])          # [steps, 32, 16]
    got = np.zeros((m, steps, 32, 16), dtype=bool)
    c0 = cols[..., 0]
    for row in range(m):
        blk = np.where(c0 < dim, (row * dim + c0) >> 4, 0)
        words = _blocks(blk, seed)                  # [steps, 32, 4]
        for e in range(16):
            byte = (words[..., e // 4] >> np.uint64(8 * (e % 4))) & \
                np.uint64(0xFF)
            got[row, :, :, e] = byte < q
    return got, cols


@pytest.mark.parametrize("m,dim", [(130, 1536), (130, 2048), (3, 1040),
                                   (1, 64)])
def test_outproj_bwd_dz_bits_are_keep_mask_bits(m, dim):
    """K8's mask, as its dz rows pass draws it, is nn.keep_mask's at K8's
    site (the forward's, row * dim + col under K3's seed): at every column
    inside the row each lane's bit equals the mask's, and every column of
    every row is taken by exactly one lane of one step."""
    seed, rate = 1234, 0.1
    q, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (m, dim), rate).numpy()
    got, cols = _dz_rows_keep(m, dim, seed, q)
    inside = cols < dim
    for row in range(m):
        assert np.array_equal(got[row][inside], mask[row, cols[inside]])
    seen = np.bincount(cols[inside], minlength=dim)
    assert (seen == 1).all()


@pytest.mark.parametrize("m,dim", [(130, 1536), (130, 2048), (1001, 1024),
                                   (8008, 1024)])
def test_outproj_dropout_bits_are_keep_mask_bits(m, dim):
    """K3's mask in the wgmma layout at its plan's tile width (64 at 130
    rows and at batch 1, where threads 2 and 3 of each quad draw blocks
    past the tile): at every position inside [m, dim], the ragged last row
    tile included, each thread's bit is nn.keep_mask's at K3's site, row *
    dim + col under the seed, and each position is held by one thread of
    one tile. 8008 rows are checked on their first and last row tiles."""
    tile_n = k3.outproj_plan(m, dim, 512).tile_n
    seed, rate = 1234, 0.1
    q, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (m, dim), rate).numpy()
    seen = np.zeros((m, dim), dtype=np.int64)
    row_tiles = list(range(0, m, 128))
    if m > 2048:
        row_tiles = [row_tiles[0], row_tiles[-1]]
    for m0 in row_tiles:
        for n0 in range(0, dim, tile_n):
            got, rows, cols = _tile_keep(m0, n0, dim, seed, q, tile_n)
            r = np.broadcast_to(rows[:, :, None, None], got.shape)
            c = np.broadcast_to(cols[:, None, :, :], got.shape)
            inside = (r < m) & (c < dim)
            assert np.array_equal(got[inside], mask[r[inside], c[inside]])
            np.add.at(seen, (r[inside], c[inside]), 1)
    held = np.zeros(m, dtype=bool)
    for m0 in row_tiles:
        held[m0:m0 + 128] = True
    assert (seen[held] == 1).all() and (seen[~held] == 0).all()
    assert tile_n == (64 if m <= 1001 else 128)


def _device_times_script():
    """scripts/torch_outproj_device_times.py, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts",
        "torch_outproj_device_times.py")
    spec = importlib.util.spec_from_file_location("outproj_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,nbytes,design,kind", [
    # K3: a, x, Wout, b in; y out. Nothing more in the design.
    ("K3", lambda m: 2 * m * 512 + 4 * m * 1024 + 2 * 512 * 1024 + 4 * 1024,
     lambda m: 0, "bf16"),
    # K11: a, x, W8, s_col, b in; y out. The design also writes a8 and
    # s_row and reads them again.
    ("K11", lambda m: 2 * m * 512 + 4 * m * 1024 + 512 * 1024 + 8 * 1024,
     lambda m: 2 * m * 512 + 8 * m, "int8"),
    # K8: dy, Wout in; dattn and dz out. At dropout 0.1 the design also
    # reads dz again.
    ("K8", lambda m: 4 * m * 1024 + 2 * 512 * 1024 + 2 * m * 512,
     lambda m: 2 * m * 1024, "bf16")])
@pytest.mark.parametrize("b", [1, 8, 32, 128])
def test_device_times_script_floors(kernel, nbytes, design, kind, b):
    """The script's bound is the function's: its bytes at 3.35 TB/s, which
    at the flagship outweigh its 2 M inner dim operations at the peak of
    their type; its design floor adds what the design moves beyond them.
    At batch 8: K3 0.0126 ms, K11 0.0124 (design 0.0149)."""
    m = b * 1001
    f = _device_times_script().floors(kernel, m)
    peak = {"bf16": 989e12, "int8": 1979e12}[kind]
    assert f["bound_by"] == "bytes"
    assert f["bound_ms"] == pytest.approx(nbytes(m) / 3.35e9)
    assert f["bound_ms"] > 2 * m * 512 * 1024 / peak * 1e3
    assert f["design_ms"] == pytest.approx((nbytes(m) + design(m)) / 3.35e9)
    if b == 8:
        want = {"K3": (0.0125, 0.0126), "K11": (0.0123, 0.0125),
                "K8": (0.0125, 0.0126)}[kernel]
        assert want[0] < f["bound_ms"] < want[1]


@pytest.mark.parametrize("b", [1, 8, 32, 128])
def test_device_times_script_k8_floor_at_dropout_0(b):
    """At dropout 0 dz is dy: K8's bound is still the function's, and its
    design writes no dz, dy and Wout in and dattn out. At batch 8 the
    design's bytes take 0.0076 ms, under the 8.4 GFLOP's 0.0085."""
    m = b * 1001
    times = _device_times_script()
    f = times.floors("K8", m, rate=0.0)
    assert f["bound_ms"] == times.floors("K8", m)["bound_ms"]
    design = 2 * m * 1024 + 2 * 512 * 1024 + 2 * m * 512
    assert f["design_ms"] == pytest.approx(design / 3.35e9)
    if b == 8:
        assert 0.0076 < f["design_ms"] < 0.0077
        assert 0.0084 < 2 * m * 512 * 1024 / 989e12 * 1e3 < 0.0086


def test_device_times_script_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without the card")
    assert _device_times_script().main([]) == 1
