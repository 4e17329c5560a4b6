"""K12, the int8 residual MLP, at the widths its TMA + wgmma design opens,
and its launch plan as a pure function.

(a) The port's int8_mlp_block on the CPU (its plain version) against the
JAX package's (the Pallas kernel in interpret mode) at dim 1280 / mlp
5120 (ViT-H) and dim 64 / mlp 8192, the widths the earlier kernel refused,
at a few tokens, with tests/test_torch_int8.py's tolerances: relative
Frobenius error <= 1e-3 at f32 and <= 2e-2 at bf16.

(b) ``mlp_plan`` (ops/int8_serving.py): four launches -- the LN row
quantizer, fc1 + GELU, g's row quantizer, fc2 + residual -- with grids
that cover the rows and columns with no spare tile, GEMM blocks of which
two fit an H100 SM's shared memory, and the scratch's pieces in order
on 256-byte boundaries. Every entry of models/vit3d.py WIDTHS, ViT-H and
mlp 8192, at the flagship's rows at batch 8 and at ragged counts.
``check_mlp_shapes`` takes those widths and refuses one that is not a
multiple of 16. The card test holds the plan's scratch and shared-memory
bytes against the kernel's own count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import int8_serving as jq
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
OPEN_WIDTHS = {"vit_h": (1280, 5120), "mlp8192": (64, 8192)}
PLAN_WIDTHS = {**{name: (w[0], w[3]) for name, w in WIDTHS.items()},
               **OPEN_WIDTHS}
# The flagship at batch 8 (8 x 1001 tokens), one row, the card test's
# ragged 130 and 33, and one full 128-row tile.
ROWS = [8008, 1, 33, 130, 128]


def _rel(got: torch.Tensor, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", list(OPEN_WIDTHS))
def test_int8_mlp_block_matches_jax_at_open_widths(width, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    dim, hid = OPEN_WIDTHS[width]
    rng = np.random.default_rng(dim + hid)
    xn = rng.standard_normal((1, 5, dim)).astype(np.float32)
    xj = jnp.asarray(xn).astype(jdt)
    xn = np.array(xj.astype(jnp.float32))
    gamma = (1.0 + 0.2 * rng.standard_normal(dim)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(dim)).astype(np.float32)

    def linear(fan_in, fan_out):        # JAX layout [in, out], torch's range
        bound = fan_in ** -0.5
        return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(
            np.float32), rng.uniform(-bound, bound, fan_out).astype(
            np.float32))

    w1, b1 = linear(dim, hid)
    w2, b2 = linear(hid, dim)
    jw1, js1 = jq.quantize_weight(jnp.asarray(w1))
    jw2, js2 = jq.quantize_weight(jnp.asarray(w2))
    block = {"mlp_norm": {"scale": jnp.asarray(gamma),
                          "bias": jnp.asarray(beta)},
             "fc1_q8": {"w": jw1, "scale": js1, "bias": jnp.asarray(b1)},
             "fc2_q8": {"w": jw2, "scale": js2, "bias": jnp.asarray(b2)}}
    want = jq.int8_mlp_block(block, xj)
    t = torch.from_numpy
    got = q8.int8_mlp_block(t(xn).to(tdt), t(gamma), t(beta),
                            *q8.quantize_weight(t(w1.T.copy())), t(b1),
                            *q8.quantize_weight(t(w2.T.copy())), t(b2))
    assert got.shape == (1, 5, dim) and got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", list(PLAN_WIDTHS))
def test_mlp_plan(width, m):
    dim, hid = PLAN_WIDTHS[width]
    q8.check_mlp_shapes(dim, hid)
    plan = q8.mlp_plan(m, dim, hid)
    names = [launch[0] for launch in plan.launches]
    assert names == ["ln_rowquant", "fc1_gelu", "g_rowquant", "fc2_residual"]
    grids = {name: grid for name, grid, _, _ in plan.launches}
    tile, rows = q8.MLP_TILE, q8.ROW_WARPS
    # Row passes: one warp a row, ROW_WARPS rows a block.
    for name in ("ln_rowquant", "g_rowquant"):
        gx, gy = grids[name]
        assert gy == 1 and (gx - 1) * rows < m <= gx * rows
    # GEMM passes: (column tiles, row tiles) of 128 x 128.
    for name, n in (("fc1_gelu", hid), ("fc2_residual", dim)):
        nt, mt = grids[name]
        assert (nt - 1) * tile < n <= nt * tile
        assert (mt - 1) * tile < m <= mt * tile
    for name, _, threads, smem in plan.launches:
        assert smem <= SMEM_LIMIT and threads <= 1024
        assert (smem > 0) == name.startswith("fc")
    # A three-stage ring of 32 KiB stages, its barriers and the alignment
    # slack; two such blocks (each with the 1 KiB the card reserves) fit
    # the SM's 228 KiB.
    gemm_smem = {smem for _, _, _, smem in plan.launches if smem}
    assert gemm_smem == {1024 + 3 * 2 * 128 * 128 + 2 * 3 * 8}
    assert 2 * (max(gemm_smem) + 1024) <= 228 * 1024
    # The scratch: g first, then u8, g8, the partial amax, the two scales.
    want = {"g": m * hid * 4, "u8": m * dim, "g8": m * hid,
            "gmax": m * grids["fc1_gelu"][0] * 4, "s1_row": m * 4,
            "s2_row": m * 4}
    assert list(plan.scratch) == list(want)
    end = 0
    for name, (offset, nbytes) in plan.scratch.items():
        assert nbytes == want[name]
        assert offset % q8.SCRATCH_ALIGN == 0 and offset >= end
        assert offset - end < q8.SCRATCH_ALIGN
        end = offset + nbytes
    assert plan.scratch["g"][0] == 0
    assert end <= plan.scratch_bytes < end + q8.SCRATCH_ALIGN


def test_mlp_plan_at_the_flagship():
    plan = q8.mlp_plan(8 * 1001, 1024, 2048)
    assert [grid for _, grid, _, _ in plan.launches] == [
        (1001, 1), (16, 63), (1001, 1), (8, 63)]
    assert plan.scratch_bytes == 90779136


@pytest.mark.parametrize("dim,hid,match", [
    (1040, 4096, None), (1280, 5120, None), (64, 8192, None),
    (2048, 16384, None), (1000, 4096, "dim as a multiple of 16"),
    (1024, 8200, "mlp_dim as a multiple of 16"),
    (8, 128, "dim as a multiple of 16")])
def test_check_mlp_shapes(dim, hid, match):
    """No row-width or shared-memory refusal is left; a width off 16 (or
    below it) is still refused and names the queue."""
    if match is None:
        q8.check_mlp_shapes(dim, hid)
        q8.mlp_plan(3, dim, hid)
        return
    for gate in (q8.check_mlp_shapes, lambda d, h: q8.mlp_plan(3, d, h)):
        with pytest.raises(ValueError, match=match) as err:
            gate(dim, hid)
        assert "ROADMAP.md, Queue 3" in str(err.value)


def test_mlp_plan_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        q8.mlp_plan(0, 1024, 2048)
