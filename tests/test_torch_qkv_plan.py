"""K2, the bf16 LN + QKV forward on TMA + wgmma: its launch plan as a pure
function, its width gate, the GEMM epilogue's column map, and its plain
version against the JAX package at the widths the earlier kernel refused.

(a) ``qkv_plan`` (ops/fused_qkv.py): two launches -- K4's LayerNorm rows
pass (one warp a row, eight rows a block), then the GEMM on K4's ring
(csrc/hopper_gemm.cuh: the 1 KiB alignment slack, three stages of a 128 x
128-byte A box and a tile x 128-byte Bt box, a full and an empty barrier
a stage), two GEMM blocks to an H100 SM -- with a GEMM grid of (3 column
tiles of inner, row tiles of 128) and 64-column tiles exactly where
128-wide tiles over [m, 3 inner] would give the card's 132 SMs fewer
blocks; a serving call's scratch holds u [m, dim] bf16 on a 256-byte
boundary, a training call's none (u is its output). Every entry of
models/vit3d.py WIDTHS, ViT-H (1280 / 16 x 80), dim 1536 / 1536 and dim
2048 / 2048, at one row, a ragged 130, one volume (1001), the flagship's
batch 8 (8008) and the train step's batch 128 (128128).

(b) The epilogue's column map (csrc/fused_qkv.cu, qkv_gemm_kernel), K10's,
modelled in index arithmetic: each of q, k and v gets every column below
inner exactly once, from Wqkv's row which * inner + c, and nothing past
inner, at the flagship, ViT-H and a ragged inner of 80 with 64-column
tiles.

(c) ``check_fwd_shapes`` takes any multiple of 16 (dim 2048 and 4096
among them: the shared-memory refusal is gone) and refuses the rest.

(d) ``fused_ln_qkv_plain`` (what the kernel is held to on the card)
against JAX's ``fused_ln_qkv`` (the Pallas kernel in interpret mode) and
its ``xla`` impl (``nn.layer_norm`` and the einsum of
``models/vit3d.py`` ``_attention``) at dim 1536 / inner 1536 and dim 2048
/ inner 2048 on 5 rows: f32 rtol = atol = 1e-4, bf16 atol 5e-2
(tests/test_torch_ops.py's tolerances).

(e) ``scripts/torch_qkv_device_times.py``'s bound and design floor, and
its refusal without the card. The card test holds the plan's bytes to the
kernel's own count.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu import nn as jnn
from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import fused_mlp, fused_qkv
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

OPEN_WIDTHS = {"vit_h": (1280, 1280), "dim1536": (1536, 1536),
               "dim2048": (2048, 2048)}
PLAN_WIDTHS = {**{name: (w[0], w[1] * w[2]) for name, w in WIDTHS.items()},
               **OPEN_WIDTHS}
ROWS = [1, 130, 1001, 8008, 128128]
SMS, TILE = 132, 128
DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-4, atol=1e-4)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=0, atol=5e-2))}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_smem(tile_n: int) -> int:
    """csrc/hopper_gemm.cuh, Mainloop<false, 128, tile_n, 3>::kSmemBytes."""
    return 1024 + 3 * (TILE + tile_n) * 128 + 2 * 3 * 8


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_qkv_plan(width, m):
    dim, inner = PLAN_WIDTHS[width]
    plan = fused_qkv.qkv_plan(m, dim, inner)
    assert [launch[0] for launch in plan.launches] == ["ln_rows", "qkv_gemm"]
    (_, (rx, ry), r_threads, r_smem), (_, (gx, gy), g_threads, g_smem) = \
        plan.launches
    # K4's LayerNorm rows pass, launch for launch.
    assert plan.launches[0] == fused_mlp.mlp_plan(m, dim, 2048).launches[0]
    assert ry == 1 and (rx - 1) * 8 < m <= rx * 8
    assert r_threads == 256 and r_smem == 0
    wide = _ceil(3 * inner, TILE) * _ceil(m, TILE)
    assert plan.tile_n == (64 if wide < SMS else TILE)
    assert (gx, gy) == (3 * _ceil(inner, plan.tile_n), _ceil(m, TILE))
    assert g_threads == 2 * 128 + 32      # two consumers and the producer
    assert g_smem == _gemm_smem(plan.tile_n) <= SMEM_LIMIT
    assert 2 * (g_smem + 1024) <= 228 * 1024
    # Serving: u [m, dim] bf16 in the scratch; training: no scratch.
    assert plan.scratch == {"u": (0, 2 * m * dim)}
    assert 2 * m * dim <= plan.scratch_bytes < 2 * m * dim + 256
    assert plan.scratch_bytes % 256 == 0
    trained = fused_qkv.qkv_plan(m, dim, inner, return_u=True)
    assert trained.launches == plan.launches
    assert trained.scratch == {} and trained.scratch_bytes == 0


def test_qkv_plan_at_the_flagship():
    """Batch 1: 64-column tiles (12 x 8 128-wide tiles would fill 96 of
    132 SMs), 24 x 8 blocks; batch 8: 12 x 63 full tiles, u 16.4 MB;
    batch 128: 12 x 1001."""
    plans = {b: fused_qkv.qkv_plan(b * 1001, 1024, 512) for b in (1, 8, 128)}
    assert plans[1].tile_n == 64
    assert [g for _, g, _, _ in plans[1].launches] == [(126, 1), (24, 8)]
    assert [s for *_, s in plans[1].launches] == [0, 74800]
    assert plans[8].tile_n == 128
    assert [g for _, g, _, _ in plans[8].launches] == [(1001, 1), (12, 63)]
    assert [s for *_, s in plans[8].launches] == [0, 99376]
    assert plans[8].scratch_bytes == 16400384
    assert plans[128].launches[1][1] == (12, 1001)


@pytest.mark.parametrize("m", [1001, 8008])
@pytest.mark.parametrize("dim,inner", [(1024, 512), (1280, 1280), (64, 80)])
def test_qkv_gemm_column_map(dim, inner, m):
    """The epilogue's map from a block's tile columns to q, k and v,
    modelled as the kernel computes it: block x serves output which = x //
    tiles at columns c0 = (x % tiles) * tile_n, reads Wqkv's rows which *
    inner + c0 on and stores a column c0 + c only below inner. Each output
    gets each column below inner once, from its own Wqkv row; the columns
    masked are exactly those whose Wqkv row lies in the next section or
    past Wqkv (TMA's zero fill)."""
    plan = fused_qkv.qkv_plan(m, dim, inner)
    tile_n = plan.tile_n
    gx = plan.launches[1][1][0]
    tiles = _ceil(inner, tile_n)
    block = np.arange(gx)[:, None]
    c = np.arange(tile_n)[None, :]
    which = np.broadcast_to(block // tiles, (gx, tile_n))
    col = (block % tiles) * tile_n + c
    w_row = which * inner + col
    stored = col < inner
    assert which.max() == 2
    for out in range(3):
        cols = col[stored & (which == out)]
        assert sorted(cols.tolist()) == list(range(inner))
        assert (w_row[stored & (which == out)] == out * inner + cols).all()
    assert (w_row[~stored] >= (which[~stored] + 1) * inner).all()
    assert stored.sum() == 3 * inner
    if inner == 80:                       # 64-column tiles, a ragged last
        assert tile_n == 64 and (~stored).sum() == 3 * 48


@pytest.mark.parametrize("dim,inner,match", [
    (1024, 512, None), (1536, 1536, None), (2048, 512, None),
    (2048, 2048, None), (4096, 4096, None), (16, 16, None),
    (72, 64, "dim as a multiple of 16"), (64, 40, "inner as a multiple of 16"),
    (2056, 512, "dim as a multiple of 16"), (8, 64, "dim as a multiple")])
def test_check_fwd_shapes(dim, inner, match):
    """The shared-memory refusal is gone (dim 2048 and 4096 are taken); a
    width off 16 (or below it) is still refused and names the queue."""
    if match is None:
        fused_qkv.check_fwd_shapes(dim, inner)
        fused_qkv.qkv_plan(3, dim, inner)
        return
    for gate in (fused_qkv.check_fwd_shapes,
                 lambda d, i: fused_qkv.qkv_plan(3, d, i)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, inner)
        assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("m", [0, -1])
def test_qkv_plan_refuses_no_rows(m):
    with pytest.raises(ValueError, match="at least one row"):
        fused_qkv.qkv_plan(m, 1024, 512)


def _jax_xla(block: dict, x, heads: int, dim_head: int):
    """The JAX model's xla impl of the LN + QKV (models/vit3d.py
    ``_attention``): nn.layer_norm, then one einsum a part into the bnhe
    layout, f32 accumulation, one rounding."""
    normed = jnn.layer_norm(block["attn_norm"], x)
    dim = x.shape[-1]
    wqkv = block["qkv"]["kernel"].astype(normed.dtype).reshape(
        dim, 3, heads, dim_head)
    prec = jnn.matmul_precision(normed.dtype)
    return tuple(jnp.einsum("bnd,dhe->bnhe", normed, wqkv[:, i],
                            preferred_element_type=jnp.float32,
                            precision=prec).astype(normed.dtype)
                 for i in range(3))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["dim1536", "dim2048"])
def test_plain_matches_jax_at_the_widths_once_refused(width, dtype, impl):
    """q, k and v at dim 1536 / 24 heads of 64 and dim 2048 / 16 heads of
    128 on 5 rows, the same seeded operands on both sides (JAX's weight
    [dim, 3 inner], torch's [3 inner, dim])."""
    jdt, tdt, tol = DTYPES[dtype]
    dim, inner = OPEN_WIDTHS[width]
    dh = 64 if dim == 1536 else 128
    heads = inner // dh
    rng = np.random.default_rng(dim + inner)
    xj = jnp.asarray(rng.standard_normal((1, 5, dim)).astype(
        np.float32)).astype(jdt)
    gamma = (1.0 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    w = rng.uniform(-1, 1, (dim, 3 * inner)).astype(np.float32) / dim ** 0.5
    block = {"attn_norm": {"scale": jnp.asarray(gamma),
                           "bias": jnp.asarray(beta)},
             "qkv": {"kernel": jnp.asarray(w)}}
    want = (jqkv.fused_ln_qkv(block, xj, heads, dh) if impl == "pallas"
            else _jax_xla(block, xj, heads, dh))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = fused_qkv.fused_ln_qkv_plain(x, torch.from_numpy(gamma),
                                       torch.from_numpy(beta),
                                       torch.from_numpy(w.T.copy()), heads,
                                       dh)
    for g, wj in zip(got, want):
        assert g.shape == (1, 5, heads, dh) and g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wj.astype(jnp.float32)), **tol)


def _device_times_script():
    """scripts/torch_qkv_device_times.py, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_qkv_device_times.py")
    spec = importlib.util.spec_from_file_location("qkv_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_times_script_floors():
    """The script's bound at the flagship at batch 8 is the function's (2 M
    dim 3 inner flops at 989 TFLOP/s: 0.0255 ms), and its design floor the
    bytes of x, u written and read, q, k, v and Wqkv at 3.35 TB/s (about
    77 MB: 0.023 ms)."""
    f = _device_times_script().floors(8008, 1024, 512)
    assert f["bound_by"] == "operations"
    assert f["bound_ms"] == pytest.approx(6 * 8008 * 1024 * 512 / 989e9)
    assert f["design_ms"] == pytest.approx(
        (6 * 8008 * 1024 + 6 * 8008 * 512 + 6 * 512 * 1024) / 3.35e9)
    assert 0.0254 < f["bound_ms"] < 0.0256 and 0.0229 < f["design_ms"] < 0.0231


def test_device_times_script_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without the card")
    assert _device_times_script().main([]) == 1
