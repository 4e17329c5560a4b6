"""A CPU model of K8 at f32 in 3xTF32 on ``wgmma``
(csrc/fused_outproj_bwd_f32.cu on csrc/tf32x3_wgmma.cuh, the weight
pre-pass ops/tf32x3.py), as far as the CPU reaches it.

- The weight pre-pass is exact: ``split_t_plain`` (the kernel's bits)
  gives big + small == Wout^T bit for bit, big with 10 mantissa bits (the
  low 13 bits clear) and equal to tests/test_torch_tf32x3.py's
  ``rna_tf32`` of Wout^T.
- dattn = dz . Wout taken as the kernel takes it: each operand split,
  along k in steps of 8, small . big, big . small, big . big, a stage's
  four steps summed in a fresh accumulator and added to the tile's f32
  sum (``mm3`` of tests/test_torch_tf32x3.py, ``steps`` 4). It is held to
  ``fused_outproj_bwd_plain`` within F32_TOL, 1e-4 (1 + |plain|), the
  bound the card tests and ``chip_smoke.py`` hold the kernel to, with dz
  (dropout 0.1) plain's own; and to ``jax.vjp`` of the JAX package's K8
  (neurovit_tpu/ops/fused_outproj.py, Pallas in interpret mode on the
  CPU, dropout 0) within the port's f32 tolerance against JAX, 1e-5 abs +
  1e-4 rel (tests/test_torch_ops_grad.py).
- The accumulator: ``mm3_rz`` models a TF32 product's rounding toward zero
  (its eight products summed exactly, then added to its accumulator and
  rounded toward zero to f32). At K8's k = 1024 one accumulator over the
  whole k (384 products deep) drifts further from the float64 product
  than a fresh accumulator a stage, which stays below F32_CAM_RTOL, 1e-5
  relative Frobenius error, the bound ``chip_smoke.py`` puts on dattn.
- A numpy model of one stage: the ``wgmma`` .tf32 register-A fragment map
  (CUTLASS's ALayout_64x8), fed by ldmatrix from the A box as TMA's
  128-byte swizzle lays it out at the row addresses that ALoader gives,
  and B read through descriptors whose start moves 32 bytes a k8 step,
  composes to the stage's product; each ldmatrix matrix's eight rows fall
  in eight distinct 16-byte bank groups (no bank conflict).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import fused_outproj as jout
from neurovit_tpu_torch.ops import fused_outproj, tf32x3
from test_torch_tf32x3 import mm3, rna_tf32, split

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_CAM_RTOL = 1e-5
# K8's stage: 32 f32 of k, four k8 steps into one fresh accumulator.
STAGE_STEPS = 4


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32))


def _wout(rng, dim, inner):
    """Wout [dim, inner] in nn.Linear's default range."""
    return torch.from_numpy((rng.uniform(-1, 1, (dim, inner))
                             / inner ** 0.5).astype(np.float32))


# --- the weight pre-pass ---------------------------------------------------

@pytest.mark.parametrize("dim,inner,scale", [(64, 64, 1.0), (1024, 512, 1.0),
                                             (48, 80, 1e3), (16, 16, 1e-30)])
def test_weight_split_is_exact(dim, inner, scale):
    """big + small == Wout^T bit for bit, big = rna_tf32(Wout^T) with the
    low 13 bits clear, small smaller than half a TF32 ulp of big."""
    w = _f32(np.random.default_rng(dim + inner), (dim, inner), scale)
    big, small = tf32x3.split_t_plain(w)
    wt = w.t().contiguous()
    assert big.shape == small.shape == (inner, dim)
    assert torch.equal(big + small, wt)
    assert torch.equal(big, rna_tf32(wt))
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert bool((small.abs() <= big.abs() * 2.0 ** -11).all())


def test_weight_split_launch_covers_the_weight():
    """The pre-pass's grid covers Wout [dim, inner] with 32 x 32 tiles."""
    for dim, inner in [(1024, 512), (64, 64), (48, 80), (1280, 1280)]:
        name, grid, threads, smem = tf32x3.split_t_launch(dim, inner)
        assert (name, threads, smem) == ("wsplit", 256, 0)
        assert grid[0] * 32 >= inner > (grid[0] - 1) * 32
        assert grid[1] * 32 >= dim > (grid[1] - 1) * 32


def test_weight_split_refuses_cpu_tensors():
    """The pre-pass's wrapper takes CUDA tensors only and counts nothing
    on the CPU."""
    before = tf32x3.split_t_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf32x3.split_t_cuda(torch.zeros(64, 32))
    assert tf32x3.split_t_cuda.launches == before


# --- the product -----------------------------------------------------------

def _dattn_3xtf32(dy, w, **kw):
    """K8 at f32 as the kernel takes it: plain's dz, then dattn = dz . Wout
    in 3xTF32, a stage's four k8 steps a fresh accumulator."""
    _, dz = fused_outproj.fused_outproj_bwd_plain(dy, w, **kw)
    m, dim = dz.numel() // dz.shape[-1], dz.shape[-1]
    da = mm3(dz.reshape(m, dim), w, STAGE_STEPS)
    return da.reshape(*dy.shape[:-1], w.shape[1]), dz


# (m, dim, inner): the 2D tutorial's 64 / 64, ragged rows and a dim off
# the stage's 32, a narrow flagship-like block.
EMUL_CASES = [(70, 64, 64), (130, 48, 80), (65, 256, 128), (33, 1024, 64)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", EMUL_CASES)
def test_emulated_dattn_within_f32_tol(m, dim, inner, rate):
    """Within 1e-4 (1 + |plain|) of the plain backward; dz is plain's;
    all-zero rows of dy give dattn = 0 there."""
    rng = np.random.default_rng(m + dim + inner)
    dy = _f32(rng, (1, m, dim))
    dy[0, [0, m - 1]] = 0
    w = _wout(rng, dim, inner)
    kw = {"dropout_rate": rate, "seed": 12}
    got, dz = _dattn_3xtf32(dy, w, **kw)
    want, want_dz = fused_outproj.fused_outproj_bwd_plain(dy, w, **kw)
    assert torch.equal(dz, want_dz)
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert bool((diff <= F32_TOL * (1 + want.abs())).all()), float(
        diff.max())
    assert not got[0, [0, m - 1]].any()


def test_emulated_dattn_matches_jax():
    """Against jax.vjp of the JAX package's f32 K8 (Pallas, interpret mode,
    dropout 0) on the same numpy inputs: dattn within 1e-5 abs + 1e-4
    rel, the port's f32 tolerance against JAX."""
    m, dim, inner = 130, 64, 64
    rng = np.random.default_rng(21)
    a = rng.standard_normal((m, inner)).astype(np.float32)
    x = rng.standard_normal((m, dim)).astype(np.float32)
    w = _wout(rng, dim, inner).numpy()          # [dim, inner], torch layout
    b = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    dy = rng.standard_normal((m, dim)).astype(np.float32)
    seed = jnp.zeros((1, 1), jnp.int32)
    _, pull = jax.vjp(lambda a_: jout._fused(
        a_, jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b), seed, 0.0),
        jnp.asarray(a))
    (want,) = pull(jnp.asarray(dy))
    got, _ = _dattn_3xtf32(torch.from_numpy(dy)[None], torch.from_numpy(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# --- the accumulator -------------------------------------------------------

def _to_f32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to f32."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mm3_rz(a: torch.Tensor, b: torch.Tensor, fresh_steps: int):
    """a [m, k] @ b [k, n] in 3xTF32 with each TF32 product's eight terms
    summed exactly and added to its accumulator rounded toward zero;
    ``fresh_steps`` k8 steps into a fresh accumulator, then added to the
    f32 sum to nearest, or (0) every product in one accumulator."""
    k = a.shape[-1]
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(acc)
    steps = -(-k // 8)
    for i in range(steps):
        s = slice(8 * i, 8 * i + 8)
        d = part if fresh_steps else acc
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            d = _to_f32_rz(d.double() + x[:, s].double() @ y[s].double())
        if not fresh_steps:
            acc = d
            continue
        part = d
        if (i + 1) % fresh_steps == 0 or i == steps - 1:
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_fresh_accumulator_beats_one_accumulator():
    """At K8's k = 1024 (dim of the flagship): the relative Frobenius error
    of dattn against the float64 product, a fresh accumulator a stage
    below F32_CAM_RTOL, one accumulator over the whole k larger; both
    printed."""
    rng = np.random.default_rng(8)
    dz = _f32(rng, (64, 1024))
    w = _wout(rng, 1024, 64)
    exact = dz.double() @ w.double()
    fresh = _rel(mm3_rz(dz, w, STAGE_STEPS), exact)
    one = _rel(mm3_rz(dz, w, 0), exact)
    f32 = _rel(dz @ w, exact)
    print(f"\nk 1024: relative Frobenius error, fresh a stage {fresh:.3e}, "
          f"one accumulator {one:.3e}, f32 matmul {f32:.3e}")
    assert fresh < F32_CAM_RTOL
    assert one > 2 * fresh


# --- one stage's fragments -------------------------------------------------

def _threads():
    """Warp, g and t of each of a warpgroup's 128 threads."""
    tid = np.arange(128)
    lane = tid % 32
    return tid // 32, lane >> 2, lane & 3


def _swizzle(rows, chunk):
    """TMA's 128-byte swizzle of a 1024-byte aligned box of 128-byte rows:
    the 16-byte chunk c of row R lies at chunk c ^ (R % 8)."""
    return chunk ^ (rows % 8)


def _box(tile):
    """A [rows, 32] f32 tile as TMA lays it out in shared memory: flat
    floats, element (R, k) at R * 32 + 4 (k / 4 ^ R % 8) + k % 4."""
    rows = np.arange(tile.shape[0])[:, None]
    k = np.arange(32)[None, :]
    flat = np.zeros(tile.size)
    flat[rows * 32 + 4 * _swizzle(rows, k >> 2) + (k & 3)] = tile
    return flat


def _ldsm_rows(wg, j):
    """The float offset each thread of warpgroup wg gives ldmatrix .x4 for
    k8 step j (ALoader): lane 8 i + r, row R = 64 wg + 16 w + r + 8 (i %
    2), chunk 2 j + i / 2 swizzled by R % 8 = r; [4 warps, 32 lanes]."""
    w, lane = np.arange(128) // 32, np.arange(128) % 32
    i, r = lane >> 3, lane & 7
    rows = 64 * wg + 16 * w + r + 8 * (i & 1)
    return (rows * 32 + 4 * _swizzle(rows, 2 * j + (i >> 1))).reshape(4, 32)


def _ldsm_x4(flat, rows):
    """ldmatrix .x4 .b16 on f32 data, per warp: register i of lane 4 g + t
    is the 32-bit word t of row g of matrix i, whose rows lanes 8 i .. 8 i
    + 7 give. rows [4, 32] -> fragments [128, 4]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    return np.concatenate([np.stack([flat[rows[w][8 * i + g] + t]
                                     for i in range(4)], axis=1)
                           for w in range(4)])


def _wgmma_rs(a_frag, b):
    """wgmma m64nNk8 .tf32 with A in registers (CUTLASS's ALayout_64x8:
    warp w, lane 4 g + t holds a0 (16 w + g, t), a1 (16 w + g + 8, t), a2
    (16 w + g, t + 4), a3 (16 w + g + 8, t + 4)) and B [N, 8] K-major:
    the accumulator fragments [128, N / 2] of A B^T (d[4 j + i] at row 16 w
    + g + 8 (i / 2), column 8 j + 2 t + i % 2)."""
    w, g, t = _threads()
    a = np.zeros((64, 8))
    for e, (dm, dk) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[16 * w + g + dm, t + dk] = a_frag[:, e]
    d = a @ b.T
    n = b.shape[0]
    return np.stack([d[16 * w + g + 8 * (e // 2 % 2), 8 * (e // 4)
                       + 2 * t + e % 2] for e in range(n // 2)], axis=1)


def _unfrag(d):
    """Accumulator fragments [128, N / 2] -> the 64 x N tile."""
    w, g, t = _threads()
    n = 2 * d.shape[1]
    out = np.zeros((64, n))
    for e in range(n // 2):
        out[16 * w + g + 8 * (e // 2 % 2), 8 * (e // 4) + 2 * t + e % 2] = \
            d[:, e]
    return out


def _b_step(box, n_rows, j):
    """The [N, 8] B that a wgmma reads from a K-major swizzled box through
    a descriptor whose start is 32 j bytes past the box's: row n's bytes
    start + 128 n + 16 c (c = 0, 1), swizzled by the address bits, so chunk
    (2 j + c) ^ (n % 8) of row n."""
    n = np.arange(n_rows)[:, None]
    c = np.arange(2)[None, :]
    chunk = _swizzle(n, 2 * j + c)
    words = n * 32 + 4 * chunk
    return np.concatenate([box[words[:, [cc]] + np.arange(4)[None, :]]
                           for cc in range(2)], axis=1)


@pytest.mark.parametrize("wg", [0, 1])
def test_register_a_fragments_compose_to_the_stage_product(wg):
    """Warpgroup wg's rows of a stage: fragments loaded by ldmatrix at
    ALoader's addresses from the swizzled A box, against B read by the
    descriptor walk from the swizzled B box, over the stage's four k8
    steps, give rows 64 wg .. + 63 of A_stage . B_stage^T."""
    rng = np.random.default_rng(wg)
    a_tile, b_tile = rng.standard_normal((128, 32)), rng.standard_normal(
        (128, 32))
    a_box, b_box = _box(a_tile), _box(b_tile)
    d = np.zeros((128, 64))
    for j in range(STAGE_STEPS):
        frag = _ldsm_x4(a_box, _ldsm_rows(wg, j))
        np.testing.assert_array_equal(
            _b_step(b_box, 128, j), b_tile[:, 8 * j:8 * j + 8])
        d += _wgmma_rs(frag, _b_step(b_box, 128, j))
    np.testing.assert_allclose(_unfrag(d), a_tile[64 * wg:64 * wg + 64]
                               @ b_tile.T, rtol=1e-12, atol=1e-12)


def test_accumulator_layout_is_the_epilogue_walk():
    """The accumulator fragments' (row, column) per thread are the pairs
    that for_each_pair hands the epilogue: (row, 8 j + 2 t) holds d[4 j],
    + 1 d[4 j + 1], row + 8 d[4 j + 2] and d[4 j + 3]."""
    w, g, t = _threads()
    tile = np.arange(64 * 128, dtype=float).reshape(64, 128)
    frag = np.stack([tile[16 * w + g + 8 * (e // 2 % 2), 8 * (e // 4) + 2 * t
                          + e % 2] for e in range(64)], axis=1)
    row = 16 * w + g
    for j in range(16):
        col = 8 * j + 2 * t
        np.testing.assert_array_equal(frag[:, 4 * j], tile[row, col])
        np.testing.assert_array_equal(frag[:, 4 * j + 1], tile[row, col + 1])
        np.testing.assert_array_equal(frag[:, 4 * j + 2], tile[row + 8, col])
        np.testing.assert_array_equal(frag[:, 4 * j + 3],
                                      tile[row + 8, col + 1])
    np.testing.assert_array_equal(_unfrag(frag), tile)


@pytest.mark.parametrize("wg", [0, 1])
def test_fragment_loads_are_conflict_free(wg):
    """Each ldmatrix matrix (eight lanes' rows of 16 bytes) of each warp and
    k8 step falls in eight distinct 16-byte bank groups of the swizzled
    box; unswizzled, the same rows would all share one."""
    for j in range(STAGE_STEPS):
        rows = _ldsm_rows(wg, j)
        for w in range(4):
            for i in range(4):
                groups = (rows[w][8 * i:8 * i + 8] * 4 // 16) % 8
                assert len(set(groups.tolist())) == 8
                plain = rows[w][8 * i:8 * i + 8] // 32 * 32 + 4 * (
                    2 * j + (i >> 1))
                assert len(set((plain * 4 // 16 % 8).tolist())) == 1


def test_variants_script_replaces_text_of_the_source():
    """scripts/torch_outproj_bwd_f32_variants.py builds each variant by
    replacing a line of csrc/fused_outproj_bwd_f32.cu: each replaced text
    is in it once, and each variant changes something."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_outproj_bwd_f32_variants.py"
    spec = importlib.util.spec_from_file_location("k8_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    this = mod.sources_of("this")
    for name, subs in mod.VARIANTS.items():
        texts = mod.sources_of(name)
        assert (texts != this) == bool(subs), name
        for fname, old, _ in subs:
            assert this[fname].count(old) == 1, (name, old)
