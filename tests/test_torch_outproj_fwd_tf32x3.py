"""A CPU model of K3 at f32 in 3xTF32 on ``wgmma``
(csrc/fused_outproj_f32.cu: one launch of K4 f32's fc2_residual pass,
csrc/fused_mlp_f32.cu, on csrc/tf32x3_wgmma.cuh's Loop, after the
forwards' weight pre-pass ops/tf32x3.py ``split_cuda``), as far as the CPU
reaches it.

- K3 f32 taken as the kernel takes it: Wout [dim, inner] split as it lies
  (``split_plain``, the pre-pass's bits; it is K-major for a . Wout^T),
  the small part read truncated to TF32 as the tensor cores read it, a
  split by tests/test_torch_tf32x3.py's ``split``; along k = inner in
  steps of 8, small . big, big . small, big . big, a stage's four steps
  summed in a fresh accumulator and added to the tile's f32 sum; then
  ``Fc2Epi``'s arithmetic: b added, the mask applied, x added in f32. It
  is held to ``fused_outproj_residual_plain`` within F32_TOL, 1e-4 (1 +
  |plain|), the bound the card tests and ``chip_smoke.py`` hold the
  kernel to, at dropout 0 and 0.1, at the flagship's widths (inner 512,
  dim 1024), the 2D tutorial's (64, 64), 80 / 48 and ragged rows; and to
  the JAX package's K3 (neurovit_tpu/ops/fused_outproj.py
  ``fused_outproj_residual``, Pallas in interpret mode on the CPU) within
  the port's f32 tolerance against JAX, 1e-5 abs + 1e-4 rel.
- The accumulator: at k = 512 (192 TF32 products deep) a fresh
  accumulator a stage stays below F32_CAM_RTOL of the float64 product with
  each TF32 product's sum rounded toward zero (``mm3_rz`` of
  tests/test_torch_outproj_bwd_tf32x3.py), as K4 f32's fc2 keeps it.
- All-zero rows of a give y = x + b bit for bit at dropout 0: the fresh
  sums of a zero row are +0.
- The epilogue's walk (``for_each_quad`` over the grid, groups past M or
  dim dropped) writes each element of y once at ragged M and dim 64, 80
  and 1024; the mask bytes a thread takes for a group from one Philox
  block (``keep_quad``) at row * dim + col are ``nn.keep_mask``'s.
- The plan (split_wout, then fc2_residual on 128 x 128 tiles over [m,
  dim]) and what the wrapper hands ``nvt_split_f32`` and
  ``nvt_fused_outproj_f32_fwd``, with the launch stubbed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_outproj as jout
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import common, fused_outproj, tf32x3
from test_torch_mlp_qkv_fwd_tf32x3 import _keep_quad, _quads, _written
from test_torch_outproj_bwd_tf32x3 import mm3_rz
from test_torch_tf32x3 import split, trunc_tf32

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_CAM_RTOL = 1e-5
# A stage of the Loop: 32 f32 of k, four k8 steps into one fresh
# accumulator (kFreshStages 1).
STAGE_STEPS = 4
# The Loop's shared memory: 1 KiB of alignment, four stages of three
# 16 KiB boxes, two barriers a stage.
SMEM = 1024 + 4 * 3 * 128 * 128 + 2 * 4 * 8


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32))


def _args(rng, m, dim, inner):
    """x [1, m, dim], attn [1, m, inner], Wout [dim, inner] in nn.Linear's
    default range, b [dim] small."""
    w = torch.from_numpy((rng.uniform(-1, 1, (dim, inner))
                          / inner ** 0.5).astype(np.float32))
    return (_f32(rng, (1, m, dim)), _f32(rng, (1, m, inner)), w,
            _f32(rng, (dim,), 0.05))


def k3_3xtf32(x, attn, w_out, b_out, *, dropout_rate=0.0, seed=0):
    """K3 at f32 as the kernel takes it: Wout's big and small as the
    pre-pass writes them (its layout, K-major), a . Wout^T in 3xTF32 with a
    fresh accumulator a stage, then Fc2Epi's bias, mask and residual."""
    dim, inner = w_out.shape
    m = x.numel() // dim
    a = attn.reshape(m, inner)
    big, small = tf32x3.split_plain(w_out)
    small = trunc_tf32(small)                  # as the tensor cores read it
    ab, as_ = split(a)
    acc = torch.zeros(m, dim)
    for k0 in range(0, inner, 8 * STAGE_STEPS):
        part = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + 8 * STAGE_STEPS, inner), 8):
            s = slice(k1, k1 + 8)
            part = part + as_[:, s] @ big[:, s].t()
            part = part + ab[:, s] @ small[:, s].t()
            part = part + ab[:, s] @ big[:, s].t()
        acc = acc + part
    z = acc + b_out
    if dropout_rate:
        z = z * nn.mask_scale(seed, z.shape, dropout_rate, x.device)
    return (z + x.reshape(m, dim)).reshape(x.shape)


def _within_tol(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert bool((diff <= F32_TOL * (1 + want.abs())).all()), float(diff.max())


# --- the product and the epilogue -------------------------------------------

def test_pre_pass_split_is_what_the_products_read():
    """Wout split as it lies is the transpose of what a . Wout^T's B
    operand split by ``split`` gives (big bit for bit, small as the tensor
    cores read it), and big + small == Wout."""
    w = _args(np.random.default_rng(1), 1, 64, 80)[2]
    big, small = tf32x3.split_plain(w)
    bb, bs = split(w.t())
    assert torch.equal(big + small, w)
    assert torch.equal(big.t(), bb)
    assert torch.equal(trunc_tf32(small).t(), bs)


# (m, dim, inner): the flagship's widths at a few rows, the 2D tutorial's
# 64 / 64 at its 197 tokens, 48 / 80 at ragged rows, one row.
CASES = [(33, 1024, 512), (197, 64, 64), (130, 48, 80), (1, 64, 64)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", CASES)
def test_emulated_k3_within_f32_tol(m, dim, inner, rate):
    """y within 1e-4 (1 + |plain|) of fused_outproj_residual_plain, at
    dropout 0 and 0.1 (the plain version's masks)."""
    args = _args(np.random.default_rng(m + dim + inner), m, dim, inner)
    kw = {"dropout_rate": rate, "seed": 33}
    _within_tol(k3_3xtf32(*args, **kw),
                fused_outproj.fused_outproj_residual_plain(*args, **kw))


@pytest.mark.parametrize("m,dim,inner", [(130, 64, 64), (70, 48, 80)])
def test_emulated_k3_matches_jax(m, dim, inner):
    """Against the JAX package's f32 K3 (Pallas, interpret mode, dropout 0)
    on the same numpy inputs: y within 1e-5 abs + 1e-4 rel, the port's f32
    tolerance against JAX."""
    x, attn, w, b = _args(np.random.default_rng(m + 41), m, dim, inner)
    want = jout.fused_outproj_residual(
        {"kernel": jnp.asarray(w.t().numpy()), "bias": jnp.asarray(
            b.numpy())}, jnp.asarray(x.numpy()), jnp.asarray(attn.numpy()))
    got = k3_3xtf32(x, attn, w, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_fresh_accumulator_holds_at_inner_512():
    """At K3's k = 512 (the flagship's attention width, 192 TF32 products
    deep), with each TF32 product's sum rounded toward zero as a wgmma
    rounds it: a fresh accumulator a stage within F32_CAM_RTOL of the
    float64 product, and no farther than one accumulator over the whole
    k."""
    rng = np.random.default_rng(31)
    a = _f32(rng, (64, 512))
    wt = _args(rng, 1, 64, 512)[2].t().contiguous()
    exact = a.double() @ wt.double()
    fresh = _rel(mm3_rz(a, wt, STAGE_STEPS), exact)
    one = _rel(mm3_rz(a, wt, 0), exact)
    print(f"\nk 512: relative Frobenius error, fresh a stage {fresh:.3e}, "
          f"one accumulator {one:.3e}")
    assert fresh < F32_CAM_RTOL
    assert fresh <= one


@pytest.mark.parametrize("m,dim,inner", [(130, 64, 64), (33, 1024, 512)])
def test_zero_rows_of_a_give_x_plus_b(m, dim, inner):
    """All-zero rows of a at a tile's first and last row and in the ragged
    tile: y = x + b there bit for bit at dropout 0, in the model and in
    plain; other rows unchanged by them."""
    x, attn, w, b = _args(np.random.default_rng(m + 5), m, dim, inner)
    rows = [r for r in (0, 127, 128, m - 1) if r < m]
    attn[0, rows] = 0
    got = k3_3xtf32(x, attn, w, b)
    want = fused_outproj.fused_outproj_residual_plain(x, attn, w, b)
    for y in (got, want):
        assert torch.equal(y[0, rows], x[0, rows] + b)
    _within_tol(got, want)


@pytest.mark.parametrize("m", [1, 130, 197, 1001])
@pytest.mark.parametrize("dim", [64, 80, 1024])
def test_epilogue_writes_each_element_once(m, dim):
    """fc2_residual's epilogue over [m, dim] (for_each_quad over the grid
    of (ceil(dim / 128), ceil(m / 128)) tiles, groups past m or dim
    dropped): every element of y written exactly once; a group never
    straddles dim (dim % 16 == 0)."""
    rows, cols = _quads(m, dim)
    assert (cols + 9 < dim).all()
    assert (_written(rows, cols, dim, (m, dim)) == 1).all()


@pytest.mark.parametrize("m,dim,rate", [(130, 80, 0.1), (3, 1024, 0.1),
                                        (197, 64, 0.5)])
def test_output_site_mask_bytes_are_keep_mask(m, dim, rate):
    """keep_quad at row * dim + col for every group of the walk: the four
    keep bits of a group from one Philox call, equal to nn.keep_mask's
    bits of the [m, dim] site, the mask plain draws."""
    seed = 0x0BAD_5EED_1234
    q, _ = nn.keep_threshold(rate)
    want = nn.keep_mask(seed, (m, dim), rate).numpy()
    got = np.zeros((m, dim), int)
    rows, cols = _quads(m, dim)
    for r, c in zip(rows.tolist(), cols.tolist()):
        for dc, bit in zip((0, 1, 8, 9), _keep_quad(r * dim + c, seed, q)):
            assert bool(bit) == bool(want[r, c + dc])
            got[r, c + dc] += 1
    assert (got == 1).all()


# --- the plan and the wrapper ------------------------------------------------

@pytest.mark.parametrize("m,dim,inner,grid", [
    (8008, 1024, 512, (8, 63)), (1001, 1024, 512, (8, 8)),
    (32032, 1024, 512, (8, 251)), (8009, 1024, 512, (8, 63)),
    (197, 64, 64, (1, 2)), (130, 48, 80, (1, 2)), (1, 1280, 1280, (10, 1))])
def test_outproj_f32_plan_launch_order_and_grids(m, dim, inner, grid):
    """split_wout (the forwards' pre-pass on Wout's dim x inner f32), then
    fc2_residual: 288 threads (two consumer warpgroups and the producer
    warp), four 48 KiB stages, one block an SM, a grid of (column tiles of
    dim, row tiles of 128); the tile 128 wide."""
    plan = fused_outproj.outproj_f32_plan(m, dim, inner)
    split_wout, gemm = plan.launches
    assert split_wout == tf32x3.split_launch("split_wout", dim * inner)
    assert gemm == ("fc2_residual", grid, 288, SMEM)
    assert gemm == tf32x3.gemm_launch("fc2_residual", m, dim)
    assert plan.tile_n == tf32x3.TILE == 128
    assert SMEM == tf32x3.SMEM <= common.SMEM_LIMIT < 2 * SMEM


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_outproj_f32_wrapper_hands_its_entry_points(monkeypatch, rate):
    """What K3 f32's wrapper hands ``launch`` on x [2, 9, 64], attn [2, 9,
    48] and Wout [64, 48]: the pre-pass on Wout (n = 3072) into big and
    small of its shape, then ``nvt_fused_outproj_f32_fwd`` with attn, x,
    Wout's big and small, b, y, M 18, inner 48, dim 64, the dropout's
    arguments and the seed; the pre-pass and K3 f32 count one launch
    each. The counters are restored after the test."""
    seen = []

    def record(symbol, argtypes, like, *args):
        seen.append((symbol, argtypes, args))

    for module in (fused_outproj, tf32x3):
        monkeypatch.setattr(module, "check_operand", lambda *a, **k: None)
        monkeypatch.setattr(module, "launch", record)
    counted = (tf32x3.split_cuda,
               fused_outproj.fused_outproj_residual_f32_cuda)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in counted]
    x, attn, w, b = _args(np.random.default_rng(7), 9, 64, 48)
    x, attn = torch.cat([x, x]), torch.cat([attn, attn])
    y = fused_outproj.fused_outproj_residual_f32_cuda(
        x, attn, w, b, dropout_rate=rate, seed=77)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert [fn.launches - b_ for fn, b_ in zip(counted, before)] == [1, 1]
    (split_sym, split_types, split_args), (sym, types, a) = seen
    assert split_sym == "nvt_split_f32" and len(split_types) == 4
    assert split_args[0].value == w.data_ptr()
    assert split_args[3:] == (64 * 48,)
    assert sym == "nvt_fused_outproj_f32_fwd" and len(types) == 12
    assert types == (common.VOID,) * 6 + (common.INT,) * 3 + (
        common.FLOAT, common.INT, common.U64)
    assert [p.value for p in a[:2]] == [attn.data_ptr(), x.data_ptr()]
    assert [p.value for p in a[2:4]] == [p.value for p in split_args[1:3]]
    assert a[5].value == y.data_ptr()
    inv_keep, keep_q = common.dropout_args(rate)
    assert a[6:] == (18, 48, 64, inv_keep, keep_q, 77)

