"""A CPU model of the f32 attention forward in 3xTF32 on ``mma.sync`` (K1
and K6 at f32, csrc/flash_attention_f32.cu on csrc/tf32x3.cuh), as far as
the CPU reaches it.

- The forward as the kernel takes it: S = Q K^T in 3xTF32 (each operand
  split into big and small, along k in steps of 8, small . big, big .
  small, big . big), all k8 steps of D <= 64 (two at D = 128) into a
  fresh accumulator added to S in f32 (``mm3`` of
  tests/test_torch_tf32x3.py); p, l and the
  dropout mask as the kernel forms them; O += (P m) V in 3xTF32, each 32
  keys' four k8 steps in a fresh accumulator added to O. It is
  held to ``flash_attention_bhnd_plain`` within F32_TOL, 1e-4 (1 +
  |plain|), the bound the card tests and ``chip_smoke.py`` hold the kernel
  to, o and the row sums l, and to the JAX package's K1 (Pallas in
  interpret mode, dropout 0) within the port's f32 tolerance against JAX
  (1e-5 abs + 1e-4 rel).
- The accumulator: with ``mm3_rz`` (tests/test_torch_outproj_bwd_tf32x3.py:
  each TF32 product's terms summed exactly, then rounded toward zero into
  its accumulator, as an MMA rounds), P V over the flagship's 1001 keys in
  one accumulator (378 products deep) drifts further from the float64
  product than a fresh accumulator every 32 keys, which stays below
  F32_CAM_RTOL, 1e-5, the relative Frobenius bound ``chip_smoke.py`` puts
  on o.
- A numpy model of one warp on the boxes TMA writes (32 f32 a 128-byte
  row, the 16-byte chunk c of row r at chunk c ^ (r % 8), a panel of the
  box's rows, 64 of Q, 32 of K or V, per 32 columns): the row addresses
  tf32x3.cuh's swizzled loaders
  give ldmatrix (``load_a_sw``, ``load_b_nk2_sw``) and ``load_b_kn_sw``'s
  loads, with the PTX ISA's m16n8k8 fragment layout, compose to the
  warp's rows of S = Q K^T and of S V; each ldmatrix matrix's eight rows
  fall in eight distinct 16-byte bank groups and each of load_b_kn_sw's
  loads in 32 distinct banks.
- The mask: lane l draws the 16 keys 16 (l % 2) .. of its warp's row
  l / 2 of a 32-key stage (``keep_bits16``: one or two Philox blocks), a
  thread takes its rows' bits by four shuffles, and each accumulator
  element reads the bit of its own (query, key) of ``nn.keep_mask``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import flash_attention as jfa
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import flash_attention as fa
from test_torch_outproj_bwd_tf32x3 import mm3_rz
from test_torch_tf32x3 import (_a_from_acc, _lanes, _load_a, _load_b_kn,
                               _load_b_nk, _mma, _unfrag, mm3)

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_CAM_RTOL = 1e-5
# The kernel's boxes: 64 query rows, 32 keys a stage (the four k8 steps of
# its P V into one fresh accumulator); S's k8 steps a fresh accumulator by
# head-dim instance (all of D <= 64, two at 128).
BQ, BKV, PV_STEPS = 64, 32, 4
S_STEPS = {32: 8, 64: 8, 128: 2}


def fwd_3xtf32(q, k, v, *, scale, n_valid, dropout_rate=0.0, seed=0,
               mm=mm3):
    """K6 at f32 ([B, H, N, D]) with both products in 3xTF32 at the
    kernel's head-dim instance (csrc/flash_attention_f32.cu); returns o and
    the row sums l [B, H, N]. ``mm(a, b, steps)`` takes each product."""
    b, h, n, d = q.shape
    dk = fa.f32_head_dim(d)
    qf, kf, vf = (fa.pad_head_dim(t.float(), dk) for t in (q, k, v))
    keep = 1.0
    s = mm(qf.reshape(-1, n, dk), kf.reshape(-1, n, dk).transpose(-1, -2),
           S_STEPS[dk]).reshape(b, h, n, n)
    e = torch.exp2(torch.clamp(s * (scale * fa.LOG2E), -fa.SCORE_CAP,
                               fa.SCORE_CAP))
    p = e * (torch.arange(n) < n_valid).float()
    lsum = p.sum(-1)
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        p = p * nn.keep_mask(seed, (b, h, n, n), dropout_rate).float()
    o = mm(p.reshape(-1, n, n), vf.reshape(-1, n, dk), PV_STEPS)
    o = o.reshape(b, h, n, dk) / (lsum[..., None] * keep)
    return o[..., :d].contiguous(), lsum


def _bhnd(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# (b, h, n, n_valid, d): ragged query and key tiles, n_valid inside the
# last key tile and on a tile edge, head dims 16 (padded to 32), 32, 64
# and 128.
EMUL_CASES = [(1, 2, 70, 33, 16), (2, 2, 65, 64, 32), (2, 2, 130, 97, 64),
              (1, 2, 100, 100, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,n_valid,d", EMUL_CASES)
def test_emulated_forward_within_f32_tol(b, h, n, n_valid, d, rate):
    """Both products in 3xTF32: o and l within 1e-4 (1 + |plain|) of the
    plain forward, with and without dropout."""
    rng = np.random.default_rng(n + d)
    q, k, v = (_bhnd(rng, (b, h, n, d)) for _ in range(3))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 7}
    got = fwd_3xtf32(q, k, v, **kw)
    want = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        diff = (g - w).abs()
        assert bool((diff <= F32_TOL * (1 + w.abs())).all()), float(
            diff.max())


@pytest.mark.parametrize("b,n,n_valid,d", [(2, 65, 60, 16), (1, 70, 70, 64),
                                           (2, 130, 97, 32)])
def test_emulated_forward_matches_jax(b, n, n_valid, d):
    """Against the JAX package's f32 K1 (Pallas, interpret mode,
    [B, N, H, D], dropout 0) on the same numpy inputs: o within 1e-5 abs
    + 1e-4 rel, the port's f32 tolerance against JAX."""
    h = 2
    rng = np.random.default_rng(n + 29)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    want = jfa._flash(*(jnp.asarray(t) for t in (q, k, v)), scale, 0.0,
                      n_valid, jnp.zeros((1, 1), jnp.int32), "bnhd")
    tq, tk, tv = (torch.from_numpy(t).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    got, _ = fwd_3xtf32(tq, tk, tv, scale=scale, n_valid=n_valid)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_fresh_accumulator_every_32_keys_beats_one_accumulator():
    """P V of 64 queries over the flagship's 1001 keys (p the exp2 of
    scores of q . k at D 64, V random), products rounded toward zero as
    the MMAs round: a fresh accumulator every 32 keys within F32_CAM_RTOL
    of the float64 product, one accumulator over every key more than twice
    as far; both printed beside f32's own matmul."""
    rng = np.random.default_rng(1001)
    s = torch.from_numpy(rng.standard_normal((64, 1001)).astype(np.float32))
    p = torch.exp2(s * (0.125 * 8 * fa.LOG2E))   # scores of q . k at D 64
    v = _bhnd(rng, (1001, 64))
    exact = p.double() @ v.double()
    fresh = _rel(mm3_rz(p, v, PV_STEPS), exact)
    one = _rel(mm3_rz(p, v, 0), exact)
    f32 = _rel(p @ v, exact)
    print(f"\nP V over 1001 keys: relative Frobenius error, fresh every 32 "
          f"keys "
          f"{fresh:.3e}, one accumulator {one:.3e}, f32 matmul {f32:.3e}")
    assert fresh < F32_CAM_RTOL
    assert one > 2 * fresh


def test_emulated_forward_error_at_the_flagship_heads():
    """Both products with the MMAs' rounding toward zero (``mm3_rz``) at
    two of the flagship's heads (1001 tokens, D 64): o's relative
    Frobenius error against plain below F32_CAM_RTOL, printed beside
    plain's own drift when q, k and v move by one ulp."""
    rng = np.random.default_rng(64)
    q, k, v = (_bhnd(rng, (1, 2, 1001, 64)) for _ in range(3))
    kw = {"scale": 0.125, "n_valid": 1001}
    want = fa.flash_attention_bhnd_plain(q, k, v, **kw)
    got, _ = fwd_3xtf32(q, k, v, mm=mm3_rz_batched, **kw)
    up = [torch.nextafter(t, torch.full_like(t, np.inf)) for t in (q, k, v)]
    drift = fa.flash_attention_bhnd_plain(*up, **kw)
    err, moved = _rel(got, want), _rel(drift, want)
    print(f"\nflagship heads: 3xTF32 (rounded toward zero) against plain "
          f"{err:.3e}; plain one ulp off {moved:.3e}")
    assert err < F32_CAM_RTOL


def mm3_rz_batched(a, b, steps):
    return torch.stack([mm3_rz(x, y, steps) for x, y in zip(a, b)])


# --- one warp on the swizzled boxes -----------------------------------------

def _swz(rows, r, c):
    """tf32x3.cuh swz128: the float offset of column c of row r in a box of
    ``rows`` rows laid out by TMA's 128-byte swizzle, in panels of 32
    columns."""
    return (c >> 5) * rows * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) \
        + (c & 3)


def _box(tile):
    """A [rows, D] tile as the swizzled panels in shared memory (flat)."""
    rows, d = tile.shape
    flat = np.zeros(rows * d)
    r, c = np.meshgrid(np.arange(rows), np.arange(d), indexing="ij")
    flat[_swz(rows, r, c)] = tile
    return flat


def _ldsm_rows(kind, rows, r0, k0):
    """The float offset each lane gives ldmatrix .x4: load_a_sw (row r0 + r
    + 8 (i % 2), column k0 + 4 (i / 2)) or load_b_nk2_sw (row r0 + r + 8
    (i / 2), column k0 + 4 (i % 2)), lane 8 i + r."""
    lane = np.arange(32)
    i, r = lane >> 3, lane & 7
    if kind == "a":
        return _swz(rows, r0 + r + 8 * (i & 1), k0 + 4 * (i >> 1))
    return _swz(rows, r0 + r + 8 * (i >> 1), k0 + 4 * (i & 1))


def _ldsm_x4(flat, addr):
    g, t = _lanes()
    return np.stack([flat[addr[8 * i + g] + t] for i in range(4)], axis=1)


def _kn_addrs(rows, k0, n0):
    """load_b_kn_sw's two loads: rows k0 + 2t and k0 + 2t + 1, column n0 +
    g, per lane."""
    g, t = _lanes()
    return _swz(rows, k0 + 2 * t, n0 + g), _swz(rows, k0 + 2 * t + 1, n0 + g)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_swizzled_fragments_compose_to_s_and_pv(d):
    """A warp's 16 rows wr .. of the 64-row Q box against a stage's 32-row
    K box: S = Q K^T from load_a_sw and load_b_nk2_sw through ldmatrix
    over d in steps of 8; then (S) V from a_from_acc and load_b_kn_sw on
    the 32-row V box, four 8-key steps per 8 columns; each fragment equal
    to the one the unswizzled tile gives."""
    rng = np.random.default_rng(d)
    qs = rng.standard_normal((BQ, d))
    ks, vs = (rng.standard_normal((BKV, d)) for _ in range(2))
    qb, kb, vb = _box(qs), _box(ks), _box(vs)
    for wr in (0, 16, 48):
        s = []
        for j in range(BKV // 8):
            c = np.zeros((32, 4))
            for kk in range(0, d, 8):
                a = _ldsm_x4(qb, _ldsm_rows("a", BQ, wr, kk))
                np.testing.assert_array_equal(a, _load_a(qs, wr, kk))
                bb = _ldsm_x4(kb, _ldsm_rows("b", BKV, 8 * (j & ~1), kk))
                b = bb[:, 2 * (j & 1):2 * (j & 1) + 2]
                np.testing.assert_array_equal(b, _load_b_nk(ks, 8 * j, kk))
                c += _mma(a, b)
            s.append(c)
        np.testing.assert_allclose(np.hstack([_unfrag(c) for c in s]),
                                   qs[wr:wr + 16] @ ks.T, rtol=1e-12,
                                   atol=1e-12)
        o = np.zeros((16, d))
        for n in range(d // 8):
            c = np.zeros((32, 4))
            for j in range(BKV // 8):
                lo, hi = _kn_addrs(BKV, 8 * j, 8 * n)
                b = np.stack([vb[lo], vb[hi]], axis=1)
                np.testing.assert_array_equal(b, _load_b_kn(vs, 8 * j, 8 * n))
                c += _mma(_a_from_acc(s[j]), b)
            o[:, 8 * n:8 * n + 8] = _unfrag(c)
        np.testing.assert_allclose(o, (qs[wr:wr + 16] @ ks.T) @ vs,
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_swizzled_loads_are_conflict_free(d):
    """Every ldmatrix matrix of load_a_sw (the 64-row Q box) and
    load_b_nk2_sw (the 32-row K box) falls in eight distinct 16-byte bank
    groups, and each of load_b_kn_sw's two loads (the 32-row V box) in 32
    distinct banks, at every warp row, key step and column tile."""
    for kind, rows in (("a", BQ), ("b", BKV)):
        for r0 in range(0, rows, 16):
            for k0 in range(0, d, 8):
                addr = _ldsm_rows(kind, rows, r0, k0)
                for i in range(4):
                    groups = (addr[8 * i:8 * i + 8] * 4 // 16) % 8
                    assert len(set(groups.tolist())) == 8
    for k0 in range(0, BKV, 8):
        for n0 in range(0, d, 8):
            for addr in _kn_addrs(BKV, k0, n0):
                assert len(set((addr % 32).tolist())) == 32


def _keep_bits16(flat, q, i0):
    """keep_bits16: bit j set where element i0 + j's byte is below q."""
    return sum(int(flat[i0 + j] < q) << j for j in range(16)
               if i0 + j < flat.size)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_draws_reach_their_elements(rate):
    """Lane l draws keep_bits16 of its warp's row l / 2, keys key0 + 16 (l
    % 2) .. of the 32-key stage at key0; the thread with lanes' g, t takes
    kept[i] = the words of lanes 2 r and 2 r + 1 (r = g + 8 i), and
    element (row g + 8 (e / 2), key key0 + 8 j + 2 t + e % 2) of the
    accumulator reads bit 8 j + 2 t + e % 2 of kept[e / 2]: nn.keep_mask's
    bit of that (query, key), in a head past the first, with the row's
    stream straddling Philox blocks (N = 1001), in the last stage too."""
    b, h, n, seed = 1, 2, 1001, 4321
    q, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (b, h, n, n), rate).numpy()[0, 1]
    flat = nn.random_bytes(seed, 0, b * h * n * n).numpy()
    row0 = 1 * n                                  # (b H + h) N, head 1
    g, t = _lanes()
    for qw, key0 in ((48, 320), (992, 992)):      # a warp's rows, a stage
        mine = [_keep_bits16(flat, q, (row0 + qw + (lane >> 1)) * n + key0
                             + 16 * (lane & 1)) if qw + (lane >> 1) < n
                else 0 for lane in range(32)]
        for lane, i in np.ndindex(32, 2):
            r = g[lane] + 8 * i
            kept = mine[2 * r] | mine[2 * r + 1] << 16
            for j, e in np.ndindex(BKV // 8, 2):
                key = key0 + 8 * j + 2 * t[lane] + e
                bit = (kept >> (8 * j + 2 * t[lane] + e)) & 1
                if qw + r < n and key < n:
                    assert bit == mask[qw + r, key]


def test_variants_script_replaces_text_of_the_sources():
    """scripts/torch_attention_fwd_f32_variants.py builds each variant by
    replacing lines of the sources: each replaced text is in them once,
    and each variant changes something."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_attention_fwd_f32_variants.py"
    spec = importlib.util.spec_from_file_location("fwd_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    this = mod.sources_of("this")
    for name, subs in mod.VARIANTS.items():
        texts = mod.sources_of(name)
        assert (texts != this) == bool(subs), name
        for fname, old, _ in subs:
            assert this[fname].count(old) == 1, (name, old[:40])
