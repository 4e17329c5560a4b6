"""A CPU model of K9 and K7 at f32 in 3xTF32 on ``wgmma``
(csrc/fused_mlp_bwd_f32.cu and csrc/fused_qkv_bwd_f32.cu on
csrc/tf32x3_ln_bwd.cuh and csrc/tf32x3_wgmma.cuh, after the transposing
weight pre-pass ops/tf32x3.py ``split_t_*``), as far as the CPU reaches
it.

- The pre-pass on W2, W1 and Wqkv: each product contracts the weight's
  out dimension, so ``split_t_plain`` (the kernel's bits) writes W^T split;
  its big is the big the MMA takes of W (``rna_tf32``), its small
  truncated to TF32 the small (tests/test_torch_tf32x3.py ``split``).
- K9 f32 and K7 f32 taken as the kernels take them: plain's LayerNorm
  statistics and dz; da = dz . W2, du = dh . W1 or dqkv . Wqkv from the
  pre-pass's operands, along k in steps of 8, small . big, big . small,
  big . big, a stage's four steps summed in a fresh accumulator and added
  to the tile's f32 sum (``mm3``, ``steps`` 4); the hidden epilogue's
  GELU, GELU' and mask; the du epilogue's LayerNorm-backward parts in the
  kernel's order (a thread's 32 columns of a row, then the quad's
  shuffles; each quad's two rows of a column, then the 64 quads in order),
  added as ``ln_bwd_rows.cuh`` adds them. They are held to
  ``fused_mlp_bwd_plain`` and ``fused_ln_qkv_bwd_plain`` within F32_TOL,
  1e-4 (1 + |plain|), with and without dropout; and to the JAX package's
  K9 and K7 (neurovit_tpu/ops/fused_mlp.py and fused_qkv.py ``_bwd_call``,
  Pallas in interpret mode on the CPU) within the port's f32 tolerance
  against JAX, 1e-5 abs + 1e-4 rel.
- The accumulator: at the du GEMM's k = 1536 (K7) and 2048 (K9) a fresh
  accumulator a stage stays below F32_CAM_RTOL of the float64 product
  under ``mm3_rz``'s rounding toward zero, one accumulator does not.
- The du epilogue's walk: every element of du written exactly once, each
  row part and column part once, at ragged M and at dim 64, 80 and 1024;
  on integer-valued operands (every sum exact) the parts added in
  ``ln_bwd_rows``' order equal the rows' and columns' sums.
- The hidden epilogue's dropout bytes (``keep_quad`` at row * hid + col of
  each ``for_each_quad`` group) are ``nn.keep_mask``'s.
- The plans (launch order, grids, threads, shared memory, scratch) at the
  flagship, the 2D tutorial's widths and ragged rows, and what the
  wrappers hand their entry points, with ``launch`` stubbed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_mlp as jmlp
from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import common, fused_mlp, fused_qkv, tf32x3
from test_torch_mlp_qkv_fwd_tf32x3 import (SMEM, STAGE_STEPS, _f32,
                                           _keep_quad, _linear, _quads,
                                           _recorded, _within_tol, _written)
from test_torch_outproj_bwd_tf32x3 import mm3_rz
from test_torch_tf32x3 import mm3, split, trunc_tf32

torch.set_num_threads(2)

F32_CAM_RTOL = 1e-5
# The Loop's tile, and the du epilogue's threads: two consumer warpgroups,
# 64 quads of four threads.
TILE, CONSUMERS, GROUPS = 128, 256, 64
# colsum's warps (ln_bwd_rows.cuh kSumWarps).
SUM_WARPS = 8


# --- the weight pre-pass ---------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(1024, 2048), (2048, 1024),
                                       (1536, 1024), (64, 128), (240, 80)])
def test_transposed_split_is_the_products_operand(rows, cols):
    """W2 [dim, hid], W1 [hid, dim] and Wqkv [3 inner, dim] are MN-major for
    the backwards' products; the pre-pass's W^T big is the MMA's big of W
    (rna_tf32) and its small, truncated as the MMA reads it, the MMA's
    small: the pre-pass's operands are those ``mm3`` takes of W."""
    w = _linear(np.random.default_rng(rows + cols), rows, cols)
    wt_big, wt_small = tf32x3.split_t_plain(w)
    assert wt_big.shape == wt_small.shape == (cols, rows)
    big, small = split(w)
    assert torch.equal(wt_big.t(), big)
    assert torch.equal(trunc_tf32(wt_small).t(), small)
    assert torch.equal((wt_big + wt_small).t(), w)


def mm3_wt(a, wt_big, wt_small):
    """a . W in 3xTF32 as the Loop takes it from the pre-pass's W^T big and
    small [n, k]: big + small is W^T exactly, so W's split is theirs."""
    return mm3(a, (wt_big + wt_small).t(), STAGE_STEPS)


# --- the du epilogue's LayerNorm-backward parts ----------------------------

def _rows_of_groups():
    """The row of each (quad, half) in a tile: quad g = 32 wg + 8 w + l
    holds rows 64 wg + 16 w + l and + 8 (half 1)."""
    g = np.arange(GROUPS)
    r0 = 64 * (g // 32) + 16 * ((g % 32) // 8) + g % 8
    return np.stack([r0, r0 + 8], axis=1)


def ln_parts(d, p, cols, m, dim):
    """The du pass's parts of one call, in its order, from [m, dim] terms:
    row parts [2, m, column tiles] of d and p (du gamma and du gamma xhat)
    over each tile's columns, thread q of a row's quad adding columns 8 j
    + 2 q and + 1, j < 16, in order, the quad's shuffles (q0 + q1) + (q2
    + q3); column parts [2, row tiles, dim] of the two terms of ``cols``
    (du xhat and du) over each tile's rows, a quad adding its two rows,
    the 64 quads added in order."""
    ct, rt = -(-dim // TILE), -(-m // TILE)

    def pad(t):
        out = torch.zeros(rt * TILE, ct * TILE, dtype=t.dtype)
        out[:m, :dim] = t
        return out

    rowparts = []
    for t in (d, p):
        q = pad(t)[:m].reshape(m, ct, 16, 4, 2)
        s = torch.zeros(m, ct, 4, dtype=t.dtype)
        for j in range(16):
            for e in range(2):
                s = s + q[:, :, j, :, e]
        rowparts.append((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3]))
    rows = torch.from_numpy(_rows_of_groups())
    colparts = []
    for t in cols:
        q = pad(t).reshape(rt, TILE, ct * TILE)
        pg = q[:, rows[:, 0]] + q[:, rows[:, 1]]
        s = torch.zeros(rt, ct * TILE, dtype=t.dtype)
        for g in range(GROUPS):
            s = s + pg[:, g]
        colparts.append(s[:, :dim])
    return torch.stack(rowparts), torch.stack(colparts)


def ln_sums(rowpart, colpart):
    """ln_bwd_rows.cuh's sums of the parts: each row's two sums over its
    column tiles in tile order; dgamma and dbeta over the row tiles, warp
    w of colsum adding tiles w, w + 8, ... in order, then the eight warps'
    sums in warp order."""
    s = torch.zeros_like(rowpart[:, :, 0])
    for t in range(rowpart.shape[2]):
        s = s + rowpart[:, :, t]
    warps = []
    for w in range(SUM_WARPS):
        acc = torch.zeros_like(colpart[:, 0])
        for t in range(w, colpart.shape[1], SUM_WARPS):
            acc = acc + colpart[:, t]
        warps.append(acc)
    cols = torch.zeros_like(colpart[:, 0])
    for acc in warps:
        cols = cols + acc
    return s, cols


def ln_bwd_as_kernel(x2, du, gamma, dy=None):
    """The du pass's epilogue and ln_bwd_rows.cuh's passes on f32 du: dx
    (+ dy), dgamma, dbeta."""
    m, dim = du.shape
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + nn.LN_EPS)
    xhat = xc * rstd
    d = du * gamma
    rowpart, colpart = ln_parts(d, d * xhat, (du * xhat, du), m, dim)
    (s1, s2), (dgamma, dbeta) = ln_sums(rowpart, colpart)
    m1, m2 = (s1 / dim)[:, None], (s2 / dim)[:, None]
    dx = rstd * (d - m1 - xhat * m2)
    return (dx if dy is None else dx + dy), dgamma, dbeta


# --- the models of K9 f32 and K7 f32 ---------------------------------------

def k9_3xtf32(dy, x, h, gamma, beta, w1, w2, *, dropout_rate=0.0,
              seeds=(0, 0)):
    """K9 at f32 as the kernel takes it: (dx, u, a, dz, dh, dgamma,
    dbeta)."""
    dim = x.shape[-1]
    x2 = x.reshape(-1, dim)
    m = x2.shape[0]
    hf = h.reshape(m, -1)
    w2t = tf32x3.split_t_plain(w2)
    w1t = tf32x3.split_t_plain(w1)
    u = nn.layer_norm(x2, gamma, beta)
    dyf = dy.reshape(m, dim)
    dz = dyf
    mask1 = torch.ones_like(hf)
    if dropout_rate:
        dz = dyf * nn.mask_scale(seeds[1], dyf.shape, dropout_rate, x.device)
        mask1 = nn.mask_scale(seeds[0], hf.shape, dropout_rate, x.device)
    da = mm3_wt(dz, *w2t)
    a = nn.gelu(hf) * mask1
    dh = da * nn.gelu_grad(hf) * mask1
    du = mm3_wt(dh, *w1t)
    dx, dgamma, dbeta = ln_bwd_as_kernel(x2, du, gamma, dyf)
    return dx.reshape(x.shape), u, a, dz, dh, dgamma, dbeta


def k7_3xtf32(dqkv, x, gamma, w_qkv):
    """K7 at f32 as the kernel takes it: (dx, dgamma, dbeta)."""
    b, n, dim = x.shape
    du = mm3_wt(dqkv.reshape(b * n, -1), *tf32x3.split_t_plain(w_qkv))
    dx, dgamma, dbeta = ln_bwd_as_kernel(x.reshape(b * n, dim), du, gamma)
    return dx.reshape(x.shape), dgamma, dbeta


def _mlp_bwd_args(rng, m, dim, hid):
    return (_f32(rng, (1, m, dim), 0.1), _f32(rng, (1, m, dim)),
            _f32(rng, (1, m, hid)), _f32(rng, (dim,), 0.1, 1.0),
            _f32(rng, (dim,), 0.1), _linear(rng, hid, dim),
            _linear(rng, dim, hid))


# (m, dim, hid): the 2D tutorial's 64 / 128, ragged rows and widths off
# the stage's 32 and the tile's 128, a narrow flagship-like block.
MLP_CASES = [(197, 64, 128), (130, 48, 80), (65, 256, 512), (33, 1024, 256)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,hid", MLP_CASES)
def test_emulated_k9_within_f32_tol(m, dim, hid, rate):
    """dx, u, a, dz, dh, dgamma and dbeta within 1e-4 (1 + |plain|) of
    fused_mlp_bwd_plain, at dropout 0 and 0.1 (the plain version's
    masks); u and dz plain's bit for bit."""
    args = _mlp_bwd_args(np.random.default_rng(m + hid + 9), m, dim, hid)
    kw = {"dropout_rate": rate, "seeds": (8, 9)}
    got = k9_3xtf32(*args, **kw)
    want = fused_mlp.fused_mlp_bwd_plain(*args, **kw)
    _within_tol(got, want)
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])


# (m, dim, heads, dim_head): the 2D tutorial's, head dim 80 (3 inner 240,
# off the stage's 32), the flagship's heads at a narrow width.
QKV_CASES = [(197, 64, 4, 16), (130, 48, 1, 80), (70, 256, 8, 64)]


@pytest.mark.parametrize("m,dim,heads,dh", QKV_CASES)
def test_emulated_k7_within_f32_tol(m, dim, heads, dh):
    """dx, dgamma and dbeta within 1e-4 (1 + |plain|) of
    fused_ln_qkv_bwd_plain."""
    rng = np.random.default_rng(m + dim + dh + 7)
    inner = heads * dh
    args = (_f32(rng, (1, m, 3 * inner), 0.1), _f32(rng, (1, m, dim)),
            _f32(rng, (dim,), 0.1, 1.0), _linear(rng, 3 * inner, dim))
    _within_tol(k7_3xtf32(*args), fused_qkv.fused_ln_qkv_bwd_plain(*args))


def test_emulated_k9_matches_jax():
    """Against the JAX package's f32 K9 (Pallas, interpret mode, dropout 0)
    on the same numpy inputs (JAX's weights [in, out]): every output within
    1e-5 abs + 1e-4 rel."""
    m, dim, hid = 130, 64, 128
    dy, x, h, gamma, beta, w1, w2 = _mlp_bwd_args(
        np.random.default_rng(43), m, dim, hid)
    want = jmlp._bwd_call(
        jnp.asarray(dy[0].numpy()), jnp.asarray(x[0].numpy()),
        jnp.asarray(h[0].numpy()), jnp.asarray(gamma.numpy()),
        jnp.asarray(beta.numpy()), jnp.asarray(w1.t().numpy()),
        jnp.asarray(w2.t().numpy()), jnp.zeros((1, 1), jnp.int32),
        dropout_rate=0.0)
    got = k9_3xtf32(dy, x, h, gamma, beta, w1, w2)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.reshape(np.shape(w_)).numpy(),
                                   np.asarray(w_), rtol=1e-4, atol=1e-5)


def test_emulated_k7_matches_jax():
    """Against the JAX package's f32 K7 (Pallas, interpret mode) on the
    same numpy inputs (JAX's dq, dk, dv apart, its weight [dim, 3 inner]):
    dx, dgamma and dbeta within 1e-5 abs + 1e-4 rel."""
    m, dim, heads, dh = 130, 64, 4, 16
    inner = heads * dh
    rng = np.random.default_rng(44)
    dqkv = _f32(rng, (1, m, 3 * inner), 0.1)
    x, gamma = _f32(rng, (1, m, dim)), _f32(rng, (dim,), 0.1, 1.0)
    w = _linear(rng, 3 * inner, dim)
    parts = [jnp.asarray(p.numpy()) for p in dqkv[0].chunk(3, dim=1)]
    want = jqkv._bwd_call(*parts, jnp.asarray(x[0].numpy()),
                          jnp.asarray(gamma.numpy()),
                          jnp.asarray(w.t().numpy()))
    got = k7_3xtf32(dqkv, x, gamma, w)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.reshape(np.shape(w_)).numpy(),
                                   np.asarray(w_), rtol=1e-4, atol=1e-5)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("k", [1536, 2048])
def test_fresh_accumulator_at_the_du_gemm(k):
    """At the du GEMM's k (3 inner = 1536 for K7, hid = 2048 for K9 at the
    flagship, 576 and 768 TF32 products deep): du's relative Frobenius
    error against the float64 product, a fresh accumulator a stage below
    F32_CAM_RTOL, one accumulator over the whole k at least twice as
    large; both printed."""
    rng = np.random.default_rng(k)
    a = _f32(rng, (64, k), 0.1)
    w = _linear(rng, k, 64)
    exact = a.double() @ w.double()
    fresh = _rel(mm3_rz(a, w, STAGE_STEPS), exact)
    one = _rel(mm3_rz(a, w, 0), exact)
    print(f"\nk {k}: relative Frobenius error, fresh a stage {fresh:.3e}, "
          f"one accumulator {one:.3e}")
    assert fresh < F32_CAM_RTOL
    assert one > 2 * fresh


# --- the epilogues' walks --------------------------------------------------

def _du_walk(m, dim):
    """What ln_du_kernel's consumer threads write over the grid of an [m,
    dim] du: (du counts [m, dim], row-part counts [m, column tiles],
    column-part counts [2, row tiles, dim])."""
    ct, rt = -(-dim // TILE), -(-m // TILE)
    du = np.zeros((m, dim), int)
    rowpart = np.zeros((m, ct), int)
    colpart = np.zeros((2, rt, dim), int)
    tid = np.arange(CONSUMERS)
    r0 = (tid // 128) * 64 + ((tid % 128) // 32) * 16 + (tid % 32) // 4
    quad = tid % 4
    for by in range(rt):
        for bx in range(ct):
            m0, n0 = by * TILE, bx * TILE
            for half in (0, 1):
                row = m0 + r0 + 8 * half
                for j in range(TILE // 8):
                    col = n0 + 8 * j + 2 * quad
                    ok = (row < m) & (col < dim)
                    for e in (0, 1):
                        np.add.at(du, (row[ok], col[ok] + e), 1)
                ok = (quad == 0) & (row < m)
                np.add.at(rowpart, (row[ok], bx), 1)
            i = tid[tid < 2 * TILE]
            c = n0 + i % TILE
            ok = c < dim
            np.add.at(colpart, ((i // TILE)[ok], by, c[ok]), 1)
    return du, rowpart, colpart


@pytest.mark.parametrize("m", [1, 130, 197, 1001])
@pytest.mark.parametrize("dim", [64, 80, 1024])
def test_du_epilogue_writes_each_element_once(m, dim):
    """Every element of du, each row part (one a column tile) and each
    column part (one a row tile, of dgamma and of dbeta) is written by
    exactly one thread, at ragged rows and at column tiles that are whole,
    ragged (80) and several (1024)."""
    du, rowpart, colpart = _du_walk(m, dim)
    assert (du == 1).all() and (rowpart == 1).all() and (colpart == 1).all()


@pytest.mark.parametrize("m,dim", [(1, 64), (130, 80), (197, 64),
                                   (300, 1024)])
def test_ln_parts_add_up_to_the_sums(m, dim):
    """On integer-valued terms (every f32 sum exact, whatever its order) the
    du pass's parts, added in ln_bwd_rows' order, equal each row's sums
    over its columns and each column's over its rows."""
    rng = np.random.default_rng(m + dim)
    t = [torch.from_numpy(rng.integers(-8, 9, (m, dim)).astype(np.float32))
         for _ in range(4)]
    rowpart, colpart = ln_parts(t[0], t[1], (t[2], t[3]), m, dim)
    (s1, s2), (c1, c2) = ln_sums(rowpart, colpart)
    for got, want in ((s1, t[0].sum(1)), (s2, t[1].sum(1)), (c1, t[2].sum(0)),
                      (c2, t[3].sum(0))):
        assert torch.equal(got, want)
    assert rowpart.shape == (2, m, -(-dim // TILE))
    assert colpart.shape == (2, -(-m // TILE), dim)


@pytest.mark.parametrize("m,hid", [(1, 128), (130, 80), (197, 2048)])
def test_hidden_epilogue_writes_each_element_once(m, hid):
    """The hidden GEMM's epilogue over [m, hid]: every element of a and dh
    written exactly once (for_each_quad's groups inside the output)."""
    rows, cols = _quads(m, hid)
    assert (_written(rows, cols, hid, (m, hid)) == 1).all()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hidden_dropout_bytes_are_keep_mask(rate):
    """keep_quad at row * hid + col of every group of the hidden site [m,
    hid] (ragged rows, a ragged column tile): the four keep bits of one
    Philox call equal nn.keep_mask's bits of the hidden site, the mask
    K4 f32's fc1 epilogue drew."""
    m, hid, seed = 130, 208, 0x0F0E_0D0C_0B0A
    q, _ = nn.keep_threshold(rate)
    want = nn.keep_mask(seed, (m, hid), rate).numpy()
    got = np.zeros((m, hid), int)
    rows, cols = _quads(m, hid)
    for r, c in zip(rows.tolist(), cols.tolist()):
        for dc, bit in zip((0, 1, 8, 9), _keep_quad(r * hid + c, seed, q)):
            assert bool(bit) == bool(want[r, c + dc])
            got[r, c + dc] += 1
    assert (got == 1).all()


# --- plans and wrappers ----------------------------------------------------

def test_mlp_and_qkv_bwd_f32_plans_launch_order_and_grids():
    """K9 f32: wsplit_w2, wsplit_w1, dz_rows, hidden, du, ln_bwd, colsum;
    K7 f32: wsplit_wqkv, row_stats, du, ln_bwd, colsum; each GEMM of 288
    threads and four 48 KiB stages, one block an SM, its grid (column
    tiles, row tiles): at the flagship (batch 8 x 1001 rows: hidden 16 x
    63, du 8 x 63), at batch 1 and 32, ragged rows and the 2D tutorial's
    widths; the pre-pass a 32 x 32 tile a block; the scratch one part a
    tile."""
    for m, dim, hid, inner, hidden, du in (
            (8008, 1024, 2048, 512, (16, 63), (8, 63)),
            (1001, 1024, 2048, 512, (16, 8), (8, 8)),
            (32032, 1024, 2048, 512, (16, 251), (8, 251)),
            (8009, 1024, 2048, 512, (16, 63), (8, 63)),
            (197, 64, 128, 64, (1, 2), (1, 2)),
            (130, 48, 80, 80, (1, 2), (1, 2))):
        plan = fused_mlp.mlp_bwd_f32_plan(m, dim, hid)
        assert [launch[0] for launch in plan.launches] == [
            "wsplit_w2", "wsplit_w1", "dz_rows", "hidden", "du", "ln_bwd",
            "colsum"]
        assert plan.launches[0] == ("wsplit_w2", (-(-hid // 32),
                                                  -(-dim // 32)), 256, 0)
        assert plan.launches[1] == ("wsplit_w1", (-(-dim // 32),
                                                  -(-hid // 32)), 256, 0)
        assert plan.launches[3] == ("hidden", hidden, 288, SMEM)
        assert plan.launches[4] == ("du", du, 288, SMEM)
        qplan = fused_qkv.qkv_bwd_f32_plan(m, dim, inner)
        assert [launch[0] for launch in qplan.launches] == [
            "wsplit_wqkv", "row_stats", "du", "ln_bwd", "colsum"]
        assert qplan.launches[0] == ("wsplit_wqkv", (-(-dim // 32),
                                                     -(-3 * inner // 32)),
                                     256, 0)
        assert qplan.launches[2] == ("du", du, 288, SMEM)
        assert qplan.scratch == plan.scratch
        assert plan.scratch["rowpart"][1] == 2 * m * du[0] * 4
        assert plan.scratch["colpart"][1] == 2 * du[1] * dim * 4
    assert SMEM == tf32x3.SMEM <= common.SMEM_LIMIT < 2 * SMEM


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_bwd_f32_wrapper_hands_its_entry_points(monkeypatch, rate):
    """What K9 f32's wrapper hands ``launch`` on x [2, 9, 64], W1 [128,
    64] and W2 [64, 128]: the pre-pass on W2 (rows 64, cols 128), then on
    W1 (128, 64), each into big and small [cols, rows], then
    ``nvt_fused_mlp_f32_bwd`` with dy, x, h, gamma, beta, W2^T's big and
    small, W1^T's big and small, dx, u, a, dz (null at dropout 0), dh,
    dgamma, dbeta, the scratch, M 18, dim 64, hid 128,
    the LN eps, the dropout's arguments and both seeds; the pre-pass counts
    two launches and K9 f32 one; at dropout 0 dz is dy itself."""
    seen = _recorded(monkeypatch)
    counted = (tf32x3.split_t_cuda, fused_mlp.fused_mlp_bwd_f32_cuda)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in counted]
    args = _mlp_bwd_args(np.random.default_rng(5), 9, 64, 128)
    dy, x, h = (torch.cat([t, t]) for t in args[:3])
    out = fused_mlp.fused_mlp_bwd_f32_cuda(dy, x, h, *args[3:],
                                           dropout_rate=rate, seeds=(3, 4))
    assert [fn.launches - b for fn, b in zip(counted, before)] == [2, 1]
    (s2, t2, a2), (s1, t1, a1), (sym, types, a) = seen
    assert s2 == s1 == "nvt_wsplit_f32" and len(t2) == len(t1) == 5
    assert a2[3:] == (64, 128) and a1[3:] == (128, 64)
    assert sym == "nvt_fused_mlp_f32_bwd" and len(types) == 25
    assert [p.value for p in a[5:7]] == [p.value for p in a2[1:3]]
    assert [p.value for p in a[7:9]] == [p.value for p in a1[1:3]]
    dx, u, a_, dz, dh, dgamma, dbeta = out
    assert [p.value for p in (a[9], a[11], a[13])] == [
        t.data_ptr() for t in (dx, a_, dh)]
    assert (a[12].value is None) == (rate == 0.0)
    if not rate:
        assert torch.equal(dz, dy.reshape(18, 64))
    assert a[16].value is not None
    inv_keep, keep_q = common.dropout_args(rate)
    assert a[17:] == (18, 64, 128, nn.LN_EPS, inv_keep, keep_q, 3, 4)


def test_qkv_bwd_f32_wrapper_hands_its_entry_points(monkeypatch):
    """What K7 f32's wrapper hands ``launch`` on dqkv [1, 9, 96] and Wqkv
    [96, 64] (2 heads of 16): the pre-pass on Wqkv (rows 96, cols 64),
    then ``nvt_fused_ln_qkv_f32_bwd`` with dqkv, x, gamma, Wqkv^T's big
    and small, dx, dgamma, dbeta, the scratch, M 9, dim 64, inner 32 and
    the LN eps; each wrapper counts its own launch."""
    seen = _recorded(monkeypatch)
    counted = (tf32x3.split_t_cuda, fused_qkv.fused_ln_qkv_bwd_f32_cuda)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in counted]
    rng = np.random.default_rng(6)
    dqkv, x, g = _f32(rng, (1, 9, 96)), _f32(rng, (1, 9, 64)), _f32(rng,
                                                                     (64,))
    dx, dgamma, dbeta = fused_qkv.fused_ln_qkv_bwd_f32_cuda(
        dqkv, x, g, _linear(rng, 96, 64))
    assert [fn.launches - b_ for fn, b_ in zip(counted, before)] == [1, 1]
    (split_sym, _, split_args), (sym, types, a) = seen
    assert split_sym == "nvt_wsplit_f32" and split_args[3:] == (96, 64)
    assert sym == "nvt_fused_ln_qkv_f32_bwd" and len(types) == 13
    assert [p.value for p in a[3:5]] == [p.value for p in split_args[1:3]]
    assert [p.value for p in a[5:8]] == [t.data_ptr()
                                         for t in (dx, dgamma, dbeta)]
    assert a[9:] == (9, 64, 32, nn.LN_EPS)
