"""A CPU model of K4 and K2 at f32 in 3xTF32 on ``wgmma``
(csrc/fused_mlp_f32.cu and csrc/fused_qkv_f32.cu on
csrc/tf32x3_wgmma.cuh, the weight pre-pass ops/tf32x3.py ``split_*``), as
far as the CPU reaches it.

- The weight pre-pass is exact: ``split_plain`` (the kernel's bits) gives
  big + small == W bit for bit, W as it lies (W1, W2 and Wqkv are K-major
  for the forwards' products), big with the low 13 bits clear and equal to
  tests/test_torch_tf32x3.py's ``rna_tf32`` of W.
- K4 f32 and K2 f32 taken as the kernels take them: plain's LayerNorm,
  then each product with its operands split, along k in steps of 8, small
  . big, big . small, big . big, a stage's four steps summed in a fresh
  accumulator and added to the tile's f32 sum (``mm3`` of
  tests/test_torch_tf32x3.py, ``steps`` 4), then the epilogues. They are
  held to ``fused_mlp_block_plain`` (y and h) and ``fused_ln_qkv_plain``
  within F32_TOL, 1e-4 (1 + |plain|), the bound the card tests and
  ``chip_smoke.py`` hold the kernels to, with and without dropout; and to
  the JAX package's K4 and K2 (neurovit_tpu/ops/fused_mlp.py and
  fused_qkv.py, Pallas in interpret mode on the CPU) within the port's f32
  tolerance against JAX, 1e-5 abs + 1e-4 rel.
- The accumulator: at fc2's k = 2048 (the flagship's MLP width, 768 TF32
  products deep) one accumulator over the whole k drifts further from the
  float64 product than a fresh accumulator a stage, which stays below
  F32_CAM_RTOL (``mm3_rz`` of tests/test_torch_outproj_bwd_tf32x3.py: each
  TF32 product's sum rounded toward zero, as a wgmma rounds it).
- The epilogue's walk: every block of the grid, every consumer thread,
  every ``for_each_quad`` group inside [M, N] writes each element of h, g
  and y, or of q, k and v, exactly once, where a 128-column tile straddles
  q, k and v (inner 64 and 80) and where it does not (512), at ragged M.
- The dropout bytes that a thread takes for a group from one Philox block
  (``keep_quad``) are ``nn.keep_mask``'s at rates 0.1 and 0.5.
- The plans (launch order, grids, threads, shared memory) at the flagship,
  the 2D tutorial's widths and ragged rows, and what the wrappers hand
  their entry points (launch stubbed); the variants script's replaced
  texts are in the sources.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_mlp as jmlp
from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import common, fused_mlp, fused_qkv, tf32x3
from test_torch_outproj_bwd_tf32x3 import mm3_rz
from test_torch_tf32x3 import mm3, rna_tf32

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_CAM_RTOL = 1e-5
# A stage of the Loop: 32 f32 of k, four k8 steps into one fresh
# accumulator.
STAGE_STEPS = 4
# The Loop's tile, its consumer threads (two warpgroups), its shared memory.
TILE, CONSUMERS = 128, 256
SMEM = 1024 + 4 * 3 * 128 * 128 + 2 * 4 * 8


def _f32(rng, shape, scale=1.0, offset=0.0):
    return torch.from_numpy((offset + scale * rng.standard_normal(shape))
                            .astype(np.float32))


def _linear(rng, out_f, in_f):
    """A torch Linear weight [out_f, in_f] in nn.Linear's default range."""
    return torch.from_numpy((rng.uniform(-1, 1, (out_f, in_f))
                             / in_f ** 0.5).astype(np.float32))


# --- the weight pre-pass ---------------------------------------------------

@pytest.mark.parametrize("rows,cols,scale", [(2048, 1024, 1.0),
                                             (1536, 1024, 1.0),
                                             (192, 64, 1e3), (16, 16, 1e-30)])
def test_weight_split_is_exact(rows, cols, scale):
    """big + small == W bit for bit, W's shape, big = rna_tf32(W) with the
    low 13 bits clear, small smaller than half a TF32 ulp of big."""
    w = _f32(np.random.default_rng(rows + cols), (rows, cols), scale)
    big, small = tf32x3.split_plain(w)
    assert big.shape == small.shape == w.shape
    assert torch.equal(big + small, w)
    assert torch.equal(big, rna_tf32(w))
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert bool((small.abs() <= big.abs() * 2.0 ** -11).all())


def test_weight_split_launch_covers_the_weight():
    """The pre-pass's grid: a 16-byte vector a thread and step, 256 threads
    a block, at most 1056 blocks walking the rest."""
    for n, blocks in [(2048 * 1024, 1056), (1536 * 1024, 1056),
                      (3 * 64 * 64, 12), (16, 1), (1056 * 1024, 1056),
                      (1055 * 1024 + 4, 1056)]:
        name, grid, threads, smem = tf32x3.split_launch("split_w1", n)
        assert (name, grid, threads, smem) == ("split_w1", (blocks, 1), 256,
                                               0)
        assert blocks * 1024 >= n or blocks == tf32x3.SPLIT_BLOCKS


def test_weight_split_refuses_cpu_tensors():
    """The pre-pass's wrapper takes CUDA tensors only and counts nothing
    on the CPU."""
    before = tf32x3.split_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf32x3.split_cuda(torch.zeros(64, 32))
    assert tf32x3.split_cuda.launches == before


# --- the products and epilogues --------------------------------------------

def _mlp_args(rng, m, dim, hid):
    return (_f32(rng, (1, m, dim)), _f32(rng, (dim,), 0.1, 1.0),
            _f32(rng, (dim,), 0.1), _linear(rng, hid, dim),
            _f32(rng, (hid,), 0.03), _linear(rng, dim, hid),
            _f32(rng, (dim,), 0.02))


def k4_3xtf32(x, gamma, beta, w1, b1, w2, b2, *, dropout_rate=0.0,
              seeds=(0, 0)):
    """K4 at f32 as the kernel takes it: plain's u, then h = u . W1^T + b1
    and z = g . W2^T + b2 in 3xTF32 with a fresh accumulator a stage, the
    epilogues' GELU, masks and residual: (y, h)."""
    dim = x.shape[-1]
    m = x.numel() // dim
    u = nn.layer_norm(x, gamma, beta).reshape(m, dim)
    h = mm3(u, w1.t(), STAGE_STEPS) + b1
    g = nn.gelu(h)
    if dropout_rate:
        g = g * nn.mask_scale(seeds[0], g.shape, dropout_rate, x.device)
    z = mm3(g, w2.t(), STAGE_STEPS) + b2
    if dropout_rate:
        z = z * nn.mask_scale(seeds[1], z.shape, dropout_rate, x.device)
    y = z + x.reshape(m, dim)
    return y.reshape(x.shape), h.reshape(*x.shape[:-1], -1)


def k2_3xtf32(x, gamma, beta, w, heads, dim_head):
    """K2 at f32 as the kernel takes it: plain's u, then u . Wqkv^T in
    3xTF32 with a fresh accumulator a stage, its columns into q, k, v:
    (q, k, v, u)."""
    b, n, dim = x.shape
    u = nn.layer_norm(x, gamma, beta)
    out = mm3(u.reshape(b * n, dim), w.t(), STAGE_STEPS)
    q, k, v = out.reshape(b, n, 3, heads, dim_head).unbind(2)
    return q.contiguous(), k.contiguous(), v.contiguous(), u


def _within_tol(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        diff = (g - w).abs()
        assert bool((diff <= F32_TOL * (1 + w.abs())).all()), float(
            diff.max())


# (m, dim, hid): the 2D tutorial's 64 / 128, ragged rows and widths off
# the stage's 32, a narrow flagship-like block.
MLP_CASES = [(197, 64, 128), (130, 48, 80), (65, 256, 512), (33, 1024, 256)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,hid", MLP_CASES)
def test_emulated_k4_within_f32_tol(m, dim, hid, rate):
    """y and h within 1e-4 (1 + |plain|) of fused_mlp_block_plain, at
    dropout 0 and 0.1 (the plain version's masks)."""
    args = _mlp_args(np.random.default_rng(m + hid), m, dim, hid)
    kw = {"dropout_rate": rate, "seeds": (8, 9)}
    got = k4_3xtf32(*args, **kw)
    want = fused_mlp.fused_mlp_block_plain(*args, return_h=True, **kw)
    _within_tol(got, want)


# (m, dim, heads, dim_head): the 2D tutorial's, head dim 80 (inner 80, a
# tile straddling q and k), the flagship's heads at a narrow width.
QKV_CASES = [(197, 64, 4, 16), (130, 48, 1, 80), (70, 256, 8, 64)]


@pytest.mark.parametrize("m,dim,heads,dh", QKV_CASES)
def test_emulated_k2_within_f32_tol(m, dim, heads, dh):
    """q, k, v and u within 1e-4 (1 + |plain|) of fused_ln_qkv_plain; u is
    plain's bit for bit."""
    rng = np.random.default_rng(m + dim + dh)
    args = (_f32(rng, (1, m, dim)), _f32(rng, (dim,), 0.1, 1.0),
            _f32(rng, (dim,), 0.1), _linear(rng, 3 * heads * dh, dim), heads,
            dh)
    got = k2_3xtf32(*args)
    want = fused_qkv.fused_ln_qkv_plain(*args, return_u=True)
    _within_tol(got, want)
    assert torch.equal(got[3], want[3])


def test_emulated_k4_matches_jax():
    """Against the JAX package's f32 K4 (Pallas, interpret mode, dropout 0)
    on the same numpy inputs: y and h within 1e-5 abs + 1e-4 rel, the
    port's f32 tolerance against JAX."""
    m, dim, hid = 130, 64, 128
    x, gamma, beta, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(41), m,
                                               dim, hid)
    y_j, h_j = jmlp._fwd_call(
        jnp.asarray(x[0].numpy()), jnp.asarray(gamma.numpy()),
        jnp.asarray(beta.numpy()), jnp.asarray(w1.t().numpy()),
        jnp.asarray(b1.numpy()), jnp.asarray(w2.t().numpy()),
        jnp.asarray(b2.numpy()), jnp.zeros((1, 1), jnp.int32),
        dropout_rate=0.0)
    y, h = k4_3xtf32(x, gamma, beta, w1, b1, w2, b2)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h[0].numpy(), np.asarray(h_j), rtol=1e-4,
                               atol=1e-5)


def test_emulated_k2_matches_jax():
    """Against the JAX package's f32 K2 (Pallas, interpret mode) on the
    same numpy inputs: q, k, v and u within 1e-5 abs + 1e-4 rel."""
    m, dim, heads, dh = 130, 64, 4, 16
    rng = np.random.default_rng(42)
    x, gamma, beta = (_f32(rng, (1, m, dim)), _f32(rng, (dim,), 0.1, 1.0),
                      _f32(rng, (dim,), 0.1))
    w = _linear(rng, 3 * heads * dh, dim)
    want = jqkv._fwd_call(jnp.asarray(x[0].numpy()),
                          jnp.asarray(gamma.numpy()),
                          jnp.asarray(beta.numpy()),
                          jnp.asarray(w.t().numpy()))
    got = k2_3xtf32(x, gamma, beta, w, heads, dh)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.reshape(m, -1).numpy(), np.asarray(w_),
                                   rtol=1e-4, atol=1e-5)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_fresh_accumulator_beats_one_accumulator_at_fc2():
    """At fc2's k = 2048 (the flagship's MLP width): the relative Frobenius
    error of g . W2^T against the float64 product, a fresh accumulator a
    stage below F32_CAM_RTOL, one accumulator over the whole k at least
    twice as large; both printed."""
    rng = np.random.default_rng(30)
    g = nn.gelu(_f32(rng, (64, 2048)))
    w2t = _linear(rng, 64, 2048).t().contiguous()
    exact = g.double() @ w2t.double()
    fresh = _rel(mm3_rz(g, w2t, STAGE_STEPS), exact)
    one = _rel(mm3_rz(g, w2t, 0), exact)
    f32 = _rel(g @ w2t, exact)
    print(f"\nk 2048: relative Frobenius error, fresh a stage {fresh:.3e}, "
          f"one accumulator {one:.3e}, f32 matmul {f32:.3e}")
    assert fresh < F32_CAM_RTOL
    assert one > 2 * fresh


# --- the epilogue's walk ---------------------------------------------------

def _quads(m, n):
    """Every (row, col) that for_each_quad hands an epilogue over the grid
    of an [m, n] output (gemm_tile: tile coordinates plus the block's
    origin, groups past m or n dropped): thread t of consumer warpgroup wg,
    row 64 wg + 16 (t / 32) + (t % 32) / 4 and + 8, col 16 p + 2 (t % 4)."""
    tid = np.arange(CONSUMERS)
    t = tid % 128
    row = (tid // 128) * 64 + (t // 32) * 16 + (t % 32) // 4
    col = 2 * (t % 4)
    rows, cols = [], []
    for by in range(-(-m // TILE)):
        for bx in range(-(-n // TILE)):
            for p in range(TILE // 16):
                for dr in (0, 8):
                    rows.append(by * TILE + row + dr)
                    cols.append(bx * TILE + 16 * p + col)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = (rows < m) & (cols < n)
    return rows[keep], cols[keep]


def _written(rows, cols, width, shape):
    """Counts of the elements (row, col), (row, col + 1), (row, col + 8),
    (row, col + 9) that the groups write into a [m, width] tensor."""
    count = np.zeros(shape, int)
    for dc in (0, 1, 8, 9):
        np.add.at(count, (rows, cols + dc), 1)
    return count


@pytest.mark.parametrize("m", [1, 130, 197, 1001])
@pytest.mark.parametrize("inner", [64, 80, 512])
def test_qkv_epilogue_writes_each_element_once(m, inner):
    """K2 f32's epilogue: each group goes to q, k or v by col / inner (a
    group never straddles two; a 128-column tile does at inner 64 and 80)
    at column col - which inner; every element of q, k and v written
    exactly once."""
    rows, cols = _quads(m, 3 * inner)
    which = cols // inner
    assert (((cols + 9) // inner) == which).all()
    for i in range(3):
        sel = which == i
        count = _written(rows[sel], cols[sel] - i * inner, inner, (m, inner))
        assert (count == 1).all(), (i, int(count.min()), int(count.max()))
    if inner % TILE:
        tiles = {(c // TILE, w) for c, w in zip(cols.tolist(),
                                                which.tolist())}
        assert any(len({w for t_, w in tiles if t_ == t}) > 1
                   for t, _ in tiles)


@pytest.mark.parametrize("m,dim,hid", [(1, 64, 128), (130, 48, 80),
                                       (197, 64, 128), (1001, 1024, 2048)])
def test_mlp_epilogues_write_each_element_once(m, dim, hid):
    """K4 f32's fc1 epilogue over [m, hid] (h and g) and fc2's over [m,
    dim] (y): every element written exactly once."""
    for n in (hid, dim):
        rows, cols = _quads(m, n)
        assert (_written(rows, cols, n, (m, n)) == 1).all()


def _keep_quad(i, seed, q):
    """keep_quad's four keep bits: bytes i % 16, + 1, + 8 and + 9 of
    Philox(i / 16): the word (i / 4) % 2 and that word + 2, at byte i % 4
    and the next."""
    w = nn.philox4x32(torch.tensor([i >> 4]), seed)[0].tolist()
    second = (i >> 2) & 1
    lo, hi = (w[1], w[3]) if second else (w[0], w[2])
    s = 8 * (i & 3)
    return [((lo >> s) & 0xFF) < q, ((lo >> (s + 8)) & 0xFF) < q,
            ((hi >> s) & 0xFF) < q, ((hi >> (s + 8)) & 0xFF) < q]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_quad_dropout_bytes_are_keep_mask(rate):
    """keep_quad at every group of an [m, n] site (n % 16 == 0, ragged m
    and a ragged column tile): the four elements' keep bits from one
    Philox call, equal to nn.keep_mask's bits."""
    m, n, seed = 130, 144, 0x1234_5678_9ABC
    q, _ = nn.keep_threshold(rate)
    want = nn.keep_mask(seed, (m, n), rate).numpy()
    got = np.zeros((m, n), int)
    rows, cols = _quads(m, n)
    for r, c in zip(rows.tolist(), cols.tolist()):
        i = r * n + c
        assert (i & 15) in (0, 2, 4, 6)
        for dc, bit in zip((0, 1, 8, 9), _keep_quad(i, seed, q)):
            assert bool(bit) == bool(want[r, c + dc])
            got[r, c + dc] += 1
    assert (got == 1).all()


# --- plans and wrappers ----------------------------------------------------

def test_mlp_and_qkv_f32_plans_launch_order_and_grids():
    """K4 f32: split_w1, split_w2, ln_rows, fc1_gelu, fc2_residual; K2 f32:
    split_wqkv, ln_rows, qkv_gemm; each GEMM of 288 threads (two consumer
    warpgroups and the producer warp) and four 48 KiB stages, one block
    an SM, its grid (column tiles, row tiles): at the flagship (batch 8 x
    1001 rows: fc1 16 x 63, fc2 8 x 63, qkv 12 x 63), at batch 1 and 32,
    ragged rows and the 2D tutorial's widths."""
    for m, dim, hid, inner, fc1, fc2, qkv in (
            (8008, 1024, 2048, 512, (16, 63), (8, 63), (12, 63)),
            (1001, 1024, 2048, 512, (16, 8), (8, 8), (12, 8)),
            (32032, 1024, 2048, 512, (16, 251), (8, 251), (12, 251)),
            (8009, 1024, 2048, 512, (16, 63), (8, 63), (12, 63)),
            (197, 64, 128, 64, (1, 2), (1, 2), (2, 2)),
            (130, 48, 80, 80, (1, 2), (1, 2), (2, 2))):
        plan = fused_mlp.mlp_f32_plan(m, dim, hid)
        assert [launch[0] for launch in plan.launches] == [
            "split_w1", "split_w2", "ln_rows", "fc1_gelu", "fc2_residual"]
        assert plan.launches[0] == tf32x3.split_launch("split_w1", hid * dim)
        assert plan.launches[1] == tf32x3.split_launch("split_w2", dim * hid)
        assert plan.launches[2] == ("ln_rows", (-(-m // 8), 1), 256, 0)
        assert plan.launches[3] == ("fc1_gelu", fc1, 288, SMEM)
        assert plan.launches[4] == ("fc2_residual", fc2, 288, SMEM)
        for return_u in (False, True):
            plan = fused_qkv.qkv_f32_plan(m, dim, inner, return_u=return_u)
            assert [launch[0] for launch in plan.launches] == [
                "split_wqkv", "ln_rows", "qkv_gemm"]
            assert plan.launches[0] == tf32x3.split_launch(
                "split_wqkv", 3 * inner * dim)
            assert plan.launches[2] == ("qkv_gemm", qkv, 288, SMEM)
            assert plan.tile_n == 128
    assert SMEM == tf32x3.SMEM <= common.SMEM_LIMIT < 2 * SMEM


def _recorded(monkeypatch):
    """Replace the operand checks and the launches of the wrappers and
    the pre-pass by a record; the list it fills."""
    seen = []

    def record(symbol, argtypes, like, *args):
        seen.append((symbol, argtypes, args))

    for module in (fused_mlp, fused_qkv, tf32x3):
        monkeypatch.setattr(module, "check_operand", lambda *a, **k: None)
        monkeypatch.setattr(module, "launch", record)
    return seen


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_f32_wrapper_hands_its_entry_points(monkeypatch, rate):
    """What K4 f32's wrapper hands ``launch`` on x [2, 9, 64], W1 [128,
    64] and W2 [64, 128]: the pre-pass on W1, then on W2 (n = 8192 each)
    into big and small of their shapes, then ``nvt_fused_mlp_f32_fwd``
    with x, gamma, beta, W1's big and small, b1, W2's big and small, b2,
    y, h (null when serving), the scratch, M 18, dim 64, hid 128, the LN
    eps, the dropout's arguments and both seeds; the pre-pass counts two
    launches and K4 f32 one. The counters are restored after the test."""
    seen = _recorded(monkeypatch)
    counted = (tf32x3.split_cuda, fused_mlp.fused_mlp_block_f32_cuda)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in counted]
    args = _mlp_args(np.random.default_rng(5), 9, 64, 128)
    x = torch.cat([args[0], args[0]])
    y, h = fused_mlp.fused_mlp_block_f32_cuda(
        x, *args[1:], dropout_rate=rate, seeds=(3, 4), return_h=True)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [2, 1]
    (s1, t1, a1), (s2, t2, a2), (sym, types, a) = seen
    assert s1 == s2 == "nvt_split_f32" and len(t1) == len(t2) == 4
    assert a1[3:] == a2[3:] == (8192,)
    assert sym == "nvt_fused_mlp_f32_fwd" and len(types) == 20
    assert [p.value for p in a[3:5]] == [p.value for p in a1[1:3]]
    assert [p.value for p in a[6:8]] == [p.value for p in a2[1:3]]
    assert a[9].value == y.data_ptr() and a[10].value == h.data_ptr()
    inv_keep, keep_q = common.dropout_args(rate)
    assert a[12:] == (18, 64, 128, nn.LN_EPS, inv_keep, keep_q, 3, 4)
    fused_mlp.fused_mlp_block_f32_cuda(x, *args[1:])
    assert seen[-1][2][10].value is None


def test_qkv_f32_wrapper_hands_its_entry_points(monkeypatch):
    """What K2 f32's wrapper hands ``launch`` on x [1, 9, 64] and Wqkv
    [96, 64] (2 heads of 16): the pre-pass on Wqkv (n = 6144), then
    ``nvt_fused_ln_qkv_f32_fwd`` with x, gamma, beta, Wqkv's big and
    small, q, k, v, u, M 9, dim 64, inner 32 and the LN eps; each wrapper
    counts its own launch."""
    seen = _recorded(monkeypatch)
    counted = (tf32x3.split_cuda, fused_qkv.fused_ln_qkv_f32_cuda)
    for fn in counted:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in counted]
    rng = np.random.default_rng(6)
    x, g, b = _f32(rng, (1, 9, 64)), _f32(rng, (64,)), _f32(rng, (64,))
    q, k, v, u = fused_qkv.fused_ln_qkv_f32_cuda(
        x, g, b, _linear(rng, 96, 64), 2, 16, return_u=True)
    assert [fn.launches - b_ for fn, b_ in zip(counted, before)] == [1, 1]
    (split_sym, _, split_args), (sym, types, a) = seen
    assert split_sym == "nvt_split_f32" and split_args[3:] == (6144,)
    assert sym == "nvt_fused_ln_qkv_f32_fwd" and len(types) == 13
    assert [p.value for p in a[3:5]] == [p.value for p in split_args[1:3]]
    assert [p.value for p in a[5:9]] == [t.data_ptr() for t in (q, k, v, u)]
    assert a[9:] == (9, 64, 32, nn.LN_EPS)


def test_variants_script_replaces_text_of_the_sources():
    """scripts/torch_mlp_qkv_f32_variants.py builds each variant by
    replacing lines of csrc/fused_mlp_f32.cu, csrc/fused_qkv_f32.cu or
    csrc/tf32x3_wgmma.cuh: each replaced text is in its file once, and
    each variant changes something."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_mlp_qkv_f32_variants.py"
    spec = importlib.util.spec_from_file_location("k4_k2_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    this = mod.sources_of("this")
    for name, subs in mod.VARIANTS.items():
        texts = mod.sources_of(name)
        assert (texts != this) == bool(subs), name
        for fname, old, _ in subs:
            assert this[fname].count(old) == 1, (name, fname, old)
