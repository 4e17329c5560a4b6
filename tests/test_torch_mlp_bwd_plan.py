"""K9, the bf16 residual MLP's data-grad backward on TMA + wgmma: its launch
plan as a pure function, its width gate, and its plain version against the
JAX package's backward kernel at a width the earlier kernel refused.

(a) ``mlp_bwd_plan`` (ops/fused_mlp.py): five launches -- dz rows, the
hidden GEMM (da = dz W2, a and dh in its epilogue), the du GEMM (with the
tile's partial LayerNorm-backward sums), the LayerNorm backward rows, the
column sums -- with row passes of one warp a row, GEMM grids that cover
the rows and columns with no spare tile, in K4's tiles (128 columns, or
64 where 128 would give the card's 132 SMs fewer blocks) and K4's ring
(csrc/hopper_gemm.cuh: the 1 KiB alignment slack, three stages of a 128 x
128-byte A box and a tile x 128-byte B stage, a full and an empty barrier
a stage), two GEMM blocks to an H100 SM with room in the ring for the
hidden pass's staged a and dh tiles and its h tile, and for the du pass's
column partials of 64 row groups; a column-sum lane for each column of
dgamma and dbeta; and the scratch -- du f32, the rows' (mean, rstd), the
row partials a column tile, the column partials a row tile -- on 256-byte
boundaries. Every entry of models/vit3d.py
WIDTHS and the widths the earlier wmma kernel refused (ViT-H's 1280 /
5120, 1536 / 6144), at one row, a ragged 130, one volume (1001) and the
flagship's batch 8 (8008). The card test holds the plan's bytes to the
kernel's own count.

(b) ``check_bwd_shapes`` takes any multiple of 16 and refuses the rest.

(c) ``fused_mlp_bwd_plain`` (what the kernel is held to on the card)
against JAX's ``_bwd_call`` (the Pallas kernel in interpret mode, dropout
0) at ViT-H's 1280 / 5120 on a few rows: every output within
tests/test_torch_int8_mlp.py's relative Frobenius bounds, 1e-3 at f32 and
2e-2 at bf16. The hidden pass's dropout bits are K4's fc1 bits (the same
site, row * hid + j, the same tile widths, the same quad exchange), which
tests/test_torch_mlp_plan.py models.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_mlp as jmlp
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import fused_mlp
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

OPEN_WIDTHS = {"vit_h": (1280, 5120), "dim1536": (1536, 6144)}
PLAN_WIDTHS = {**{name: (w[0], w[3]) for name, w in WIDTHS.items()},
               **OPEN_WIDTHS}
ROWS = [1, 130, 1001, 8008]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _gemm_smem(tile_n):
    """csrc/hopper_gemm.cuh, Mainloop<false, 128, tile_n, 3, *>::kSmemBytes."""
    return 1024 + 3 * (128 * 128 + tile_n * 128) + 2 * 3 * 8


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_mlp_bwd_plan(width, m):
    dim, hid = PLAN_WIDTHS[width]
    plan = fused_mlp.mlp_bwd_plan(m, dim, hid)
    assert [launch[0] for launch in plan.launches] == [
        "dz_rows", "hidden", "du", "ln_bwd", "colsum"]
    grids = {name: grid for name, grid, _, _ in plan.launches}
    smem = {name: s for name, _, _, s in plan.launches}
    threads = {name: t for name, _, t, _ in plan.launches}
    assert threads == {"dz_rows": 256, "hidden": 288, "du": 288,
                       "ln_bwd": 256, "colsum": 256}
    for name in ("dz_rows", "ln_bwd"):  # one warp a row, 8 a block
        gx, gy = grids[name]
        assert gy == 1 and (gx - 1) * 8 < m <= gx * 8
    gx, gy = grids["colsum"]            # a lane a column of dgamma, dbeta
    assert gy == 1 and gx * 32 == 2 * dim
    assert smem["dz_rows"] == smem["ln_bwd"] == smem["colsum"] == 0
    for name, n in (("hidden", hid), ("du", dim)):
        nt, mt = grids[name]            # (column tiles, row tiles)
        assert (mt - 1) * 128 < m <= mt * 128
        tile_n = 64 if -(-n // 128) * mt < 132 else 128
        assert (nt - 1) * tile_n < n <= nt * tile_n
        assert smem[name] == _gemm_smem(tile_n)
        # Two GEMM blocks (each with the 1 KiB the card reserves and the
        # hidden pass's 8-byte barrier) fit the SM's 228 KiB, one fits a
        # block's limit, and the ring (past the slack and before the
        # barriers) holds the hidden pass's three bf16 tiles of 128 x
        # tile_n (a and dh staged, h loaded) and the du pass's f32 column
        # partials, [2, 64, tile_n + 8].
        assert 2 * (smem[name] + 1024 + 8) <= 228 * 1024
        assert smem[name] <= SMEM_LIMIT
        ring = smem[name] - 1024 - 48
        assert ring >= 3 * 128 * tile_n * 2
        assert ring >= 2 * 64 * (tile_n + 8) * 4
    m_tiles, n_tiles = grids["du"][1], grids["du"][0]
    want = {"du": m * dim * 4, "stats": m * 8,
            "rowpart": 2 * m * n_tiles * 4,
            "colpart": 2 * m_tiles * dim * 4}
    assert list(plan.scratch) == list(want)
    end = 0
    for name, (offset, nbytes) in plan.scratch.items():
        assert nbytes == want[name]
        assert offset % fused_mlp.SCRATCH_ALIGN == 0 and offset >= end
        assert offset - end < fused_mlp.SCRATCH_ALIGN
        end = offset + nbytes
    assert plan.scratch["du"][0] == 0
    assert end <= plan.scratch_bytes < end + fused_mlp.SCRATCH_ALIGN


def test_mlp_bwd_plan_at_the_flagship():
    """Batch 8: 63 row tiles, 16 x 63 hidden blocks and 8 x 63 du blocks
    of 128 x 128 (K4's fc1 and fc2 grids), 1001 blocks of 8 rows; du (32.8
    MB), the statistics, 8008 x 8 row partials and 63 x 1024 column
    partials of each sum in one 33.9 MB scratch. One volume: 64-column
    tiles, as K4's."""
    plan = fused_mlp.mlp_bwd_plan(8 * 1001, 1024, 2048)
    assert [grid for _, grid, _, _ in plan.launches] == [
        (1001, 1), (16, 63), (8, 63), (1001, 1), (64, 1)]
    assert [s for *_, s in plan.launches] == [0, 99376, 99376, 0, 0]
    assert plan.scratch == {"du": (0, 32800768), "stats": (32800768, 64064),
                            "rowpart": (32865024, 512512),
                            "colpart": (33377536, 516096)}
    assert plan.scratch_bytes == 33893632
    k4 = fused_mlp.mlp_plan(8 * 1001, 1024, 2048)
    assert plan.launches[1][1:] == k4.launches[1][1:]
    assert plan.launches[2][1:] == k4.launches[2][1:]
    one = fused_mlp.mlp_bwd_plan(1001, 1024, 2048)
    assert [grid for _, grid, _, _ in one.launches] == [
        (126, 1), (32, 8), (16, 8), (126, 1), (64, 1)]
    assert [s for *_, s in one.launches] == [0, 74800, 74800, 0, 0]


@pytest.mark.parametrize("dim,hid,match", [
    (1280, 5120, None), (1536, 6144, None), (2048, 8192, None),
    (16, 16, None), (1000, 4096, "dim as a multiple of 16"),
    (1536, 6152, "mlp_dim as a multiple of 16"),
    (8, 128, "dim as a multiple of 16")])
def test_check_bwd_shapes(dim, hid, match):
    """The dim <= 1024 refusal is gone; a width off 16 (or below it) is
    still refused and names the queue."""
    if match is None:
        fused_mlp.check_bwd_shapes(dim, hid)
        fused_mlp.mlp_bwd_plan(3, dim, hid)
        return
    for gate in (fused_mlp.check_bwd_shapes,
                 lambda d, h: fused_mlp.mlp_bwd_plan(3, d, h)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, hid)
        assert "ROADMAP.md, Queue 3" in str(err.value)


def test_mlp_bwd_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        fused_mlp.mlp_bwd_plan(0, 1024, 2048)


def _rel(got: torch.Tensor, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_bwd_plain_matches_jax_at_vit_h(dtype):
    """dx, u, a, dz, dh, dgamma and dbeta at dim 1280 / mlp 5120 on 7 rows,
    the same seeded operands on both sides (JAX's weights [in, out],
    torch's [out, in])."""
    jdt, tdt, tol = DTYPES[dtype]
    dim, hid = OPEN_WIDTHS["vit_h"]
    rng = np.random.default_rng(dim + hid)

    def act(*shape, scale=1.0):
        j = jnp.asarray(scale * rng.standard_normal(shape).astype(
            np.float32)).astype(jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    (xj, xt), (hj, ht), (dyj, dyt) = (act(7, dim), act(7, hid),
                                      act(7, dim, scale=0.1))
    gamma = (1.0 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    w1 = rng.uniform(-1, 1, (dim, hid)).astype(np.float32) / dim ** 0.5
    w2 = rng.uniform(-1, 1, (hid, dim)).astype(np.float32) / hid ** 0.5
    w1j, w2j = jnp.asarray(w1).astype(jdt), jnp.asarray(w2).astype(jdt)
    w1t, w2t = (torch.from_numpy(np.array(w.astype(jnp.float32).T)).to(tdt)
                for w in (w1j, w2j))
    seed = jnp.zeros((1, 1), jnp.int32)
    want = jmlp._bwd_call(dyj, xj, hj, jnp.asarray(gamma), jnp.asarray(beta),
                          w1j, w2j, seed, dropout_rate=0.0)
    got = fused_mlp.fused_mlp_bwd_plain(
        dyt.reshape(1, 7, dim), xt.reshape(1, 7, dim), ht,
        torch.from_numpy(gamma), torch.from_numpy(beta), w1t, w2t)
    names = ["dx", "u", "a", "dz", "dh", "dgamma", "dbeta"]
    for name, g, w in zip(names, got, want):
        g = g.reshape(w.shape)
        assert g.dtype == (torch.float32 if name in ("dgamma", "dbeta")
                           else tdt), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
