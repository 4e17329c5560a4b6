"""K7, the LN + QKV backward on TMA + wgmma: its launch plan as a pure
function, its width gate, and its plain version against the JAX package's
backward kernel at a width the earlier kernel refused.

(a) ``qkv_bwd_plan`` (ops/fused_qkv.py): four launches -- each row's
LayerNorm statistics, then K9's last three passes (csrc/ln_bwd.cuh): the
du GEMM over K = 3 inner (with the tile's partial LayerNorm-backward
sums), the LayerNorm backward rows, the column sums -- with row passes of
one warp a row, a du grid that covers the rows and columns with no spare
tile, in K4's tiles (128 columns, or 64 where 128 would give the card's
132 SMs fewer blocks) and K4's ring (csrc/hopper_gemm.cuh: the 1 KiB
alignment slack, three stages of a 128 x 128-byte A box and a tile x
128-byte B stage, a full and an empty barrier a stage), two GEMM blocks to
an H100 SM with room in the ring for the du pass's column partials of 64
row groups; a column-sum lane for each column of dgamma and dbeta; and the
scratch -- du f32, the rows' (mean, rstd), the row partials a column tile,
the column partials a row tile -- on 256-byte boundaries, K9's own layout
for the same rows and dim. Every entry of models/vit3d.py WIDTHS and the
widths the earlier wmma kernel refused (ViT-H's 1280 / 16 x 80, 1536 /
1536), at one row, a ragged 130, one volume (1001), the flagship's batch
8 (8008) and the train step's batch 128 (128128). The card test holds the
plan's bytes to the kernel's own count.

(b) ``check_bwd_shapes`` takes any multiple of 16 and refuses the rest.

(c) ``fused_ln_qkv_bwd_plain`` (what the kernel is held to on the card)
against JAX's ``_bwd_call`` (the Pallas kernel in interpret mode) at
ViT-H's dim 1280 / inner 1280 on a few rows: dx, dgamma and dbeta within
tests/test_torch_mlp_bwd_plan.py's relative Frobenius bounds, 1e-3 at f32
and 2e-2 at bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import fused_mlp, fused_qkv
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

OPEN_WIDTHS = {"vit_h": (1280, 1280), "dim1536": (1536, 1536)}
PLAN_WIDTHS = {**{name: (w[0], w[1] * w[2]) for name, w in WIDTHS.items()},
               **OPEN_WIDTHS}
ROWS = [1, 130, 1001, 8008, 128128]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _gemm_smem(tile_n):
    """csrc/hopper_gemm.cuh, Mainloop<false, 128, tile_n, 3, true>::
    kSmemBytes."""
    return 1024 + 3 * (128 * 128 + tile_n * 128) + 2 * 3 * 8


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_qkv_bwd_plan(width, m):
    dim, inner = PLAN_WIDTHS[width]
    plan = fused_qkv.qkv_bwd_plan(m, dim, inner)
    assert [launch[0] for launch in plan.launches] == [
        "row_stats", "du", "ln_bwd", "colsum"]
    grids = {name: grid for name, grid, _, _ in plan.launches}
    smem = {name: s for name, _, _, s in plan.launches}
    threads = {name: t for name, _, t, _ in plan.launches}
    assert threads == {"row_stats": 256, "du": 288, "ln_bwd": 256,
                       "colsum": 256}
    for name in ("row_stats", "ln_bwd"):  # one warp a row, 8 a block
        gx, gy = grids[name]
        assert gy == 1 and (gx - 1) * 8 < m <= gx * 8
    gx, gy = grids["colsum"]              # a lane a column of dgamma, dbeta
    assert gy == 1 and gx * 32 == 2 * dim
    assert smem["row_stats"] == smem["ln_bwd"] == smem["colsum"] == 0
    nt, mt = grids["du"]                  # (column tiles, row tiles)
    assert (mt - 1) * 128 < m <= mt * 128
    tile_n = 64 if -(-dim // 128) * mt < 132 else 128
    assert (nt - 1) * tile_n < dim <= nt * tile_n
    assert smem["du"] == _gemm_smem(tile_n)
    # Two GEMM blocks (each with the 1 KiB the card reserves) fit the SM's
    # 228 KiB, one fits a block's limit, and the ring (past the slack and
    # before the barriers) holds the du pass's f32 column partials, [2, 64,
    # tile_n + 8].
    assert 2 * (smem["du"] + 1024) <= 228 * 1024
    assert smem["du"] <= SMEM_LIMIT
    assert smem["du"] - 1024 - 48 >= 2 * 64 * (tile_n + 8) * 4
    want = {"du": m * dim * 4, "stats": m * 8, "rowpart": 2 * m * nt * 4,
            "colpart": 2 * mt * dim * 4}
    assert list(plan.scratch) == list(want)
    end = 0
    for name, (offset, nbytes) in plan.scratch.items():
        assert nbytes == want[name]
        assert offset % fused_mlp.SCRATCH_ALIGN == 0 and offset >= end
        assert offset - end < fused_mlp.SCRATCH_ALIGN
        end = offset + nbytes
    assert plan.scratch["du"][0] == 0
    assert end <= plan.scratch_bytes < end + fused_mlp.SCRATCH_ALIGN
    # K9's last three passes and its scratch, at any mlp_dim.
    k9 = fused_mlp.mlp_bwd_plan(m, dim, 2048)
    assert plan.launches[1:] == k9.launches[2:]
    assert (plan.scratch, plan.scratch_bytes) == (k9.scratch,
                                                 k9.scratch_bytes)


def test_qkv_bwd_plan_at_the_flagship():
    """Batch 8: 1001 blocks of 8 rows, 8 x 63 du blocks of 128 x 128 (K9's
    du grid), 64 colsum blocks; du (32.8 MB), the statistics, 8008 x 8 row
    partials and 63 x 1024 column partials of each sum in one 33.9 MB
    scratch. One volume: 64-column tiles. Batch 128: 8 x 1001 blocks."""
    plan = fused_qkv.qkv_bwd_plan(8 * 1001, 1024, 512)
    assert [grid for _, grid, _, _ in plan.launches] == [
        (1001, 1), (8, 63), (1001, 1), (64, 1)]
    assert [s for *_, s in plan.launches] == [0, 99376, 0, 0]
    assert plan.scratch == {"du": (0, 32800768), "stats": (32800768, 64064),
                            "rowpart": (32865024, 512512),
                            "colpart": (33377536, 516096)}
    assert plan.scratch_bytes == 33893632
    one = fused_qkv.qkv_bwd_plan(1001, 1024, 512)
    assert [grid for _, grid, _, _ in one.launches] == [
        (126, 1), (16, 8), (126, 1), (64, 1)]
    assert [s for *_, s in one.launches] == [0, 74800, 0, 0]
    step = fused_qkv.qkv_bwd_plan(128 * 1001, 1024, 512)
    assert step.launches[1][1] == (8, 1001)


@pytest.mark.parametrize("dim,inner,match", [
    (1280, 1280, None), (1536, 1536, None), (2048, 2048, None),
    (16, 16, None), (1024, 520, "inner as a multiple of 16"),
    (1288, 512, "dim as a multiple of 16"),
    (8, 64, "dim as a multiple of 16")])
def test_check_bwd_shapes(dim, inner, match):
    """The dim <= 1024 refusal is gone; a width off 16 (or below it) is
    still refused and names the queue."""
    if match is None:
        fused_qkv.check_bwd_shapes(dim, inner)
        fused_qkv.qkv_bwd_plan(3, dim, inner)
        return
    for gate in (fused_qkv.check_bwd_shapes,
                 lambda d, i: fused_qkv.qkv_bwd_plan(3, d, i)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, inner)
        assert "ROADMAP.md, Queue 3" in str(err.value)


def test_qkv_bwd_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        fused_qkv.qkv_bwd_plan(0, 1024, 512)


def _rel(got: torch.Tensor, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qkv_bwd_plain_matches_jax_at_vit_h(dtype):
    """dx, dgamma and dbeta at dim 1280 / 16 heads of 80 on 7 rows, the
    same seeded operands on both sides (JAX's weight [dim, 3 inner],
    torch's [3 inner, dim]; JAX's dq, dk, dv, the port's one dqkv)."""
    jdt, tdt, tol = DTYPES[dtype]
    dim, inner = OPEN_WIDTHS["vit_h"]
    rng = np.random.default_rng(dim + inner)

    def act(*shape, scale=1.0):
        j = jnp.asarray(scale * rng.standard_normal(shape).astype(
            np.float32)).astype(jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    xj, xt = act(7, dim)
    dj = [act(7, inner, scale=0.1) for _ in range(3)]
    gamma = (1.0 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
    w = rng.uniform(-1, 1, (dim, 3 * inner)).astype(np.float32) / dim ** 0.5
    wj = jnp.asarray(w).astype(jdt)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32).T)).to(tdt)
    want = jqkv._bwd_call(*(d[0] for d in dj), xj, jnp.asarray(gamma), wj)
    dqkv = torch.cat([d[1] for d in dj], dim=1).reshape(1, 7, 3 * inner)
    got = fused_qkv.fused_ln_qkv_bwd_plain(dqkv, xt.reshape(1, 7, dim),
                                           torch.from_numpy(gamma), wt)
    for name, g, w_ in zip(["dx", "dgamma", "dbeta"], got, want):
        g = g.reshape(w_.shape)
        assert g.dtype == (torch.float32 if name != "dx" else tdt), name
        assert _rel(g, w_) <= tol, (name, _rel(g, w_))
