"""K10, the int8 LN + QKV, as a launch plan: ``qkv_plan``
(ops/int8_serving.py) as a pure function.

Two launches -- the LN row quantizer K10 shares with K12, then the GEMM on
the TMA + wgmma mainloop -- with grids that cover the rows and the three
outputs' columns, GEMM blocks of which two fit an H100 SM's shared memory,
64-column tiles exactly where 128-wide tiles would give the card's 132 SMs
fewer blocks, and the scratch's pieces in order on 256-byte boundaries.
The GEMM epilogue's column map (csrc/int8_qkv.cu, qkv_gemm_kernel) is
modelled in index arithmetic: each of q, k and v gets every column below
inner exactly once, from W8's row which * inner + c, and nothing past
inner. At the flagship at batch 1, 8 and 32, every entry of
models/vit3d.py WIDTHS, ViT-H (dim 1280, 16 heads of 80) and dim 1536.
``check_qkv_shapes`` and the plan refuse widths that are not multiples of
16 and fewer than one row. The card test holds the plan's scratch and
shared-memory bytes against the kernel's own count.
"""

import numpy as np
import pytest

from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

# name -> (dim, inner)
PLAN_WIDTHS = {**{name: (w[0], w[1] * w[2]) for name, w in WIDTHS.items()},
               "vit_h": (1280, 1280), "dim1536": (1536, 1536)}
# The flagship at batch 1, 8 and 32 (x 1001 tokens), one row, the card
# tests' ragged 130 and 65, and one full 128-row tile.
ROWS = [1001, 8008, 32032, 1, 65, 130, 128]
SMS = 132
TILE = 128


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_smem(tile_n: int) -> int:
    """csrc/hopper_gemm.cuh, Mainloop<true, 128, tile_n, 3>::kSmemBytes:
    the 1 KiB alignment slack, three stages of a 128 x 128-byte A box and
    a tile_n x 128-byte Bt box, and a full and an empty barrier a stage."""
    return 1024 + 3 * (TILE + tile_n) * 128 + 2 * 3 * 8


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_qkv_plan(width, m):
    dim, inner = PLAN_WIDTHS[width]
    q8.check_qkv_shapes(dim, inner)
    plan = q8.qkv_plan(m, dim, inner)
    assert [launch[0] for launch in plan.launches] == ["ln_rowquant",
                                                        "qkv_gemm"]
    (_, (rx, ry), r_threads, r_smem), (_, (gx, gy), g_threads, g_smem) = \
        plan.launches
    # The row pass: one warp a row, eight rows a block, no shared memory.
    assert ry == 1 and (rx - 1) * 8 < m <= rx * 8
    assert r_threads == 256 and r_smem == 0
    # The GEMM: 128-row tiles; 128 columns, or 64 where 128-wide tiles over
    # the [m, 3 inner] output make fewer blocks than SMs.
    wide = _ceil(3 * inner, TILE) * _ceil(m, TILE)
    assert plan.tile_n == (64 if wide < SMS else TILE)
    tiles = _ceil(inner, plan.tile_n)
    assert (gx, gy) == (3 * tiles, _ceil(m, TILE))
    assert g_threads == 2 * 128 + 32      # two consumers and the producer
    assert g_smem == _gemm_smem(plan.tile_n) <= SMEM_LIMIT
    assert 2 * (g_smem + 1024) <= 228 * 1024
    # The scratch: u8 [m, dim] int8, then s_row [m] f32.
    assert list(plan.scratch) == ["u8", "s_row"]
    assert plan.scratch["u8"] == (0, m * dim)
    offset, nbytes = plan.scratch["s_row"]
    assert nbytes == 4 * m and offset % 256 == 0
    assert m * dim <= offset < m * dim + 256
    assert offset + nbytes <= plan.scratch_bytes < offset + nbytes + 256
    assert plan.scratch_bytes % 256 == 0


@pytest.mark.parametrize("width", list(PLAN_WIDTHS) + ["inner320",
                                                       "inner384"])
@pytest.mark.parametrize("m", [1001, 8008])
def test_qkv_gemm_column_map(width, m):
    """The epilogue's map from a block's tile columns to q, k and v,
    modelled as the kernel computes it: block x serves output which = x //
    tiles at columns c0 = (x % tiles) * tile_n, reads W8's rows which *
    inner + c0 on and stores a column c0 + c only below inner. Each output
    gets each column below inner once, from its own W8 row; the columns
    masked are exactly those whose W8 row lies in the next section or past
    W8 (TMA's zero fill)."""
    dim, inner = {"inner320": (64, 320), "inner384": (384, 384)}.get(
        width, PLAN_WIDTHS.get(width))
    plan = q8.qkv_plan(m, dim, inner)
    tile_n = plan.tile_n
    gx = plan.launches[1][1][0]
    tiles = _ceil(inner, tile_n)
    block = np.arange(gx)[:, None]
    c = np.arange(tile_n)[None, :]
    which = np.broadcast_to(block // tiles, (gx, tile_n))
    col = (block % tiles) * tile_n + c
    w8_row = which * inner + col
    stored = col < inner
    assert which.max() == 2
    for out in range(3):
        cols = col[stored & (which == out)]
        assert sorted(cols.tolist()) == list(range(inner))
        assert (w8_row[stored & (which == out)]
                == out * inner + cols).all()
    masked = w8_row[~stored]
    assert ((masked >= (which[~stored] + 1) * inner)).all()
    assert stored.sum() == 3 * inner


def test_qkv_plan_at_the_flagship():
    """Batch 8: 12 x 63 full tiles, no tile wasted; batch 1: 64-column
    tiles (12 x 8 128-wide tiles would fill 96 of 132 SMs); batch 32: 12 x
    251."""
    plans = {b: q8.qkv_plan(b * 1001, 1024, 512) for b in (1, 8, 32)}
    assert [g for _, g, _, _ in plans[8].launches] == [(1001, 1), (12, 63)]
    assert plans[8].scratch_bytes == 8232448
    assert plans[1].tile_n == 64
    assert plans[1].launches[1][1] == (24, 8)
    assert plans[32].launches[1][1] == (12, 251)


@pytest.mark.parametrize("dim,inner,match", [
    (1024, 512, None), (1280, 1280, None), (1536, 1536, None),
    (2048, 2048, None), (64, 320, None),
    (72, 64, "dim as a multiple of 16"), (1288, 1280, "dim as a multiple"),
    (1024, 40, "inner as a multiple of 16"), (8, 64, "dim as a multiple")])
def test_check_qkv_shapes(dim, inner, match):
    """No row-width refusal is left; a width off 16 (or below it) is still
    refused and names the queue."""
    if match is None:
        q8.check_qkv_shapes(dim, inner)
        q8.qkv_plan(3, dim, inner)
        return
    for gate in (q8.check_qkv_shapes, lambda d, i: q8.qkv_plan(3, d, i)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, inner)
        assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("m", [0, -1])
def test_qkv_plan_refuses_no_rows(m):
    with pytest.raises(ValueError, match="at least one row"):
        q8.qkv_plan(m, 1024, 512)


def _device_times_script():
    """scripts/torch_int8_qkv_device_times.py, loaded by path."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts",
        "torch_int8_qkv_device_times.py")
    spec = importlib.util.spec_from_file_location("qkv_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_times_script_floors():
    """The script's bound at the flagship at batch 8 is the function's (6 M
    dim inner int8 operations at 1,979 TOP/s: 0.0127 ms), and its design
    floor the bytes of x, the codes written and read, q, k, v and W8 at
    3.35 TB/s (0.0176 ms)."""
    f = _device_times_script().floors(8008, 1024, 512)
    assert f["bound_by"] == "operations"
    assert f["bound_ms"] == pytest.approx(6 * 8008 * 1024 * 512 / 1979e9)
    assert f["design_ms"] == pytest.approx(
        (4 * 8008 * 1024 + 6 * 8008 * 512 + 3 * 512 * 1024) / 3.35e9)
    assert 0.0127 < f["bound_ms"] < 0.0128 and 0.0175 < f["design_ms"] < 0.018


def test_device_times_script_needs_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without the card")
    assert _device_times_script().main([]) == 1
