"""A CPU model of the 3xTF32 arithmetic of the f32 attention backward (K5
and K6's backward at f32, csrc/flash_attention_bwd_f32.cu on
csrc/tf32x3.cuh), and of the index maps of its mma.sync fragments.

- ``rna_tf32`` rounds f32 to TF32 as ``cvt.rna.tf32.f32`` does: to
  nearest, ties away from zero, 10 mantissa bits (add 0x1000 to the bit
  pattern, then clear the low 13 bits), checked on hand-picked patterns.
- ``mm3`` takes a product as the kernel does: each operand split into big
  = rna(x) and small = x - big, which the tensor cores read truncated to
  TF32 (``trunc_tf32``), and along k, 8 at a time (one m16n8k8 step),
  small . big, big . small and big . big summed apart over a few steps
  (``steps``: 2 for S and dP, the tile's 4 for dQ, dK and dV) and that sum
  added to an f32 accumulator. This models the tensor cores' accumulation
  only approximately: an MMA sums its 8 exact products and its
  accumulator in the hardware's own order and rounds toward zero, here an
  f32 matmul of 8 terms and f32 adds that round to nearest.
- The backward with every one of its seven products so (pass 1: S, dP,
  dQ; pass 2: S^T, dP^T, dK, dV) is held to ``flash_attention_bwd_plain``
  within F32_TOL, 1e-4 (1 + |plain|), the bound the card tests and
  ``chip_smoke.py`` hold the kernel to, and to ``jax.vjp`` of the JAX
  package's Pallas attention (interpret mode) within the port's f32
  tolerance against JAX (tests/test_torch_ops_grad.py). At the 2D probe's
  block and the flagship's heads, its relative Frobenius error against
  plain is held below F32_CAM_RTOL, 1e-5, the bound ``chip_smoke.py``'s
  (k) and (l) put on the f32 CAMs and probe gradients against the CPU,
  and printed beside plain's own drift when q, k, v and dO move by one
  ulp.
- A numpy model of one warp: fragments gathered by the loaders' index
  maps (load_a, load_b_nk2, load_b_kn, a_from_acc) and the PTX ISA's
  m16n8k8 fragment layout compose to the products the passes need; the
  row addresses that load_a and load_b_nk2 give ldmatrix yield those
  fragments, with no shared-memory bank conflict at rows D + 4 apart; and
  the lanes' shuffles of the dropout bits hand each accumulator element
  its own key's bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import flash_attention as jfa
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_CAM_RTOL = 1e-5


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as cvt.rna.tf32.f32 (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of f32 x: the TF32 value the tensor cores read."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """big and small as the MMAs read them."""
    big = rna_tf32(x)
    return big, trunc_tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """a @ b in 3xTF32, k in steps of 8 (k zero-padded to a multiple),
    ``steps`` of them summed apart before each add to the f32 sum."""
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, k + pad, 8 * steps):
        part = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + 8 * steps, k + pad), 8):
            s = slice(k1, k1 + 8)
            part = part + as_[..., s] @ bb[..., s, :]
            part = part + ab[..., s] @ bs[..., s, :]
            part = part + ab[..., s] @ bb[..., s, :]
        acc = acc + part
    return acc


def bwd_3xtf32(q, k, v, o, do, lsum, *, scale, n_valid, dropout_rate=0.0,
               seed=0):
    """K6's backward at f32 ([B, H, N, D]) with its seven products in
    3xTF32, at the kernel's head-dim instance, step by step as its two
    passes take them (csrc/flash_attention_bwd_f32.cu)."""
    d = q.shape[-1]
    dk_ = fa.f32_head_dim(d)
    qf, kf, vf, of, dof = (fa.pad_head_dim(t.float(), dk_)
                           for t in (q, k, v, o, do))
    n = q.shape[2]
    keep, mask = 1.0, None
    if dropout_rate:
        _, keep = nn.keep_threshold(dropout_rate)
        mask = nn.keep_mask(seed, (q.shape[0], q.shape[1], n, n),
                            dropout_rate).float()
    scale_log2 = scale * fa.LOG2E
    ds_scale = scale / keep
    delta = keep * (dof * of).sum(-1)
    valid = (torch.arange(n) < n_valid).float()

    def probs(s, l):
        e = torch.exp2(torch.clamp(s * scale_log2, -fa.SCORE_CAP,
                                   fa.SCORE_CAP))
        return e * valid / l

    # Pass 1: rows are queries.
    s = mm3(qf, kf.transpose(-1, -2), 2)
    dp = mm3(dof, vf.transpose(-1, -2), 2)
    p = probs(s, lsum[..., None])
    dpm = dp * mask if mask is not None else dp
    ds = p * (dpm - delta[..., None]) * ds_scale
    dq = mm3(ds, kf, 4)
    # Pass 2: rows are keys.
    st = mm3(kf, qf.transpose(-1, -2), 2)
    dpt = mm3(vf, dof.transpose(-1, -2), 2)
    pt = probs(st.transpose(-1, -2), lsum[..., None]).transpose(-1, -2)
    mt = mask.transpose(-1, -2) if mask is not None else None
    pmt = pt * mt if mt is not None else pt
    dst = pt * ((dpt * mt if mt is not None else dpt)
                - delta[..., None, :]) * ds_scale
    dkk = mm3(dst, qf, 4)
    dv = mm3(pmt, dof, 4) * (1.0 / keep)
    return tuple(t[..., :d].contiguous() for t in (dq, dkk, dv))


def _bhnd(rng, shape, offset=0.0):
    return torch.from_numpy((offset + rng.standard_normal(shape)).astype(
        np.float32))


def _problem(shape, n_valid, rate, seed=0):
    b, h, n, d = shape
    rng = np.random.default_rng(seed + n + d)
    q, k, v, do = (_bhnd(rng, shape) for _ in range(4))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 7}
    o, lsum = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True, **kw)
    return (q, k, v, o, do, lsum), kw


# --- the rounding ----------------------------------------------------------

# (f32 bits, TF32 bits): the low 13 bits decide; 0x1000 is the tie.
RNA_CASES = [
    (0x3F800000, 0x3F800000),   # 1.0, exact
    (0x3F800FFF, 0x3F800000),   # below the tie: down
    (0x3F801000, 0x3F802000),   # the tie: away from zero
    (0x3F801001, 0x3F802000),   # above the tie: up
    (0x3F803000, 0x3F804000),   # the tie above an odd mantissa: up
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),   # a negative below the tie
    (0x3FFFF000, 0x40000000),   # the carry into the exponent (2.0)
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x00000FFF, 0x00000000),   # a subnormal below the tie: +0
    (0x807FF000, 0x80800000),   # a negative subnormal up to the normal
    (0x7F7FF000, 0x7F800000),   # the largest f32 tie: +inf
]


@pytest.mark.parametrize("bits,want", RNA_CASES)
def test_rna_tf32_bit_patterns(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    got = rna_tf32(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, f"{bits:#010x} -> {got:#010x}, want {want:#010x}"


def test_split_keeps_21_bits():
    """big + small is x to 2^-21 relative (x - big is exact, the MMA reads
    11 of its 13 bits), both parts TF32 (low 13 bits zero)."""
    x = _bhnd(np.random.default_rng(0), (4096,)) * 1e3
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -21
    assert float(((big - x).abs() / x.abs()).max()) > 2.0 ** -14


def test_mm3_is_near_f32_and_far_from_one_tf32_product():
    """3xTF32 within a few f32 rounding errors of the float64 product; one
    TF32 product (big . big) three orders of magnitude farther."""
    rng = np.random.default_rng(1)
    a, b = _bhnd(rng, (64, 256)), _bhnd(rng, (256, 48))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    three = float(((mm3(a, b, 1).double() - exact).abs() / scale).max())
    one = float(((rna_tf32(a) @ rna_tf32(b)).double() - exact).abs().div(
        scale).max())
    f32 = float(((a @ b).double() - exact).abs().div(scale).max())
    assert three < 8 * max(f32, 2.0 ** -24) and one > 100 * three


# --- the emulated backward -------------------------------------------------

# (b, h, n, n_valid, d): ragged n_valid in the last tiles, head dims 16
# (padded to 32), 64 and 128.
EMUL_CASES = [(1, 2, 70, 33, 16), (2, 2, 65, 60, 64), (1, 2, 100, 97, 128)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,n_valid,d", EMUL_CASES)
def test_emulated_backward_within_f32_tol(b, h, n, n_valid, d, rate):
    """Every product in 3xTF32: within 1e-4 (1 + |plain|) of the plain
    backward, and no gradient for keys at or past n_valid."""
    args, kw = _problem((b, h, n, d), n_valid, rate)
    got = bwd_3xtf32(*args, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        diff = (g - w).abs()
        assert bool((diff <= F32_TOL * (1 + w.abs())).all()), float(
            diff.max())
    assert not got[1][:, :, n_valid:].any()
    assert not got[2][:, :, n_valid:].any()


def test_emulated_backward_matches_jax():
    """Against jax.vjp of the JAX package's f32 Pallas attention (interpret
    mode, [B, N, H, D], dropout 0), on o and the row sums of the port's
    plain forward: within 1e-5 abs + 1e-4 rel, the port's f32 tolerance
    against JAX."""
    b, n, n_valid, h, d = 2, 65, 60, 4, 16
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((b, n, h, d)).astype(np.float32)
                  for _ in range(4))
    scale = d ** -0.5
    seed = jnp.zeros((1, 1), jnp.int32)
    _, pull = jax.vjp(lambda q_, k_, v_: jfa._flash(
        q_, k_, v_, scale, 0.0, n_valid, seed, "bnhd"),
        *(jnp.asarray(t) for t in (q, k, v)))
    want = pull(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(t).transpose(1, 2).contiguous()
                      for t in (q, k, v, g))
    kw = {"scale": scale, "n_valid": n_valid}
    o, lsum = fa.flash_attention_bhnd_plain(tq, tk, tv, return_stats=True,
                                            **kw)
    got = bwd_3xtf32(tq, tk, tv, o, tg, lsum, **kw)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.transpose(1, 2).numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("shape,label", [((2, 4, 197, 16), "2D probe"),
                                         ((1, 2, 1001, 64), "flagship")])
def test_emulated_backward_error_beside_one_ulp_drift(shape, label):
    """Relative Frobenius error of the emulated dq, dk, dv against plain,
    below F32_CAM_RTOL and printed beside plain's own drift with q, k, v
    and dO one ulp up (o and the row sums recomputed)."""
    args, kw = _problem(shape, shape[2], 0.0, seed=5)
    want = fa.flash_attention_bhnd_bwd_plain(*args, **kw)
    got = bwd_3xtf32(*args, **kw)
    q, k, v, _, do, _ = args
    up = [torch.nextafter(t, torch.full_like(t, np.inf))
          for t in (q, k, v, do)]
    o1, l1 = fa.flash_attention_bhnd_plain(*up[:3], return_stats=True, **kw)
    drift = fa.flash_attention_bhnd_bwd_plain(*up[:3], o1, up[3], l1, **kw)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    drifts = [_rel(g, w) for g, w in zip(drift, want)]
    print(f"\n{label} {list(shape)}: 3xTF32 against plain dq dk dv "
          + " ".join(f"{e:.3e}" for e in errs) + "; plain one ulp off "
          + " ".join(f"{e:.3e}" for e in drifts))
    assert max(errs) < F32_CAM_RTOL


# --- one warp's fragments --------------------------------------------------

def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3


def _mma(a_frag, b_frag):
    """m16n8k8 by the PTX ISA's .tf32 layouts: a_frag [32, 4], b_frag
    [32, 2] per lane -> the C fragments [32, 4] of A B."""
    g, t = _lanes()
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for r, (dm, dk) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        a[g + dm, t + dk] = a_frag[:, r]
    for r, dk in enumerate([0, 4]):
        b[t + dk, g] = b_frag[:, r]
    c = a @ b
    return np.stack([c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                     c[g + 8, 2 * t + 1]], axis=1)


def _load_a(tile, m0, k0):
    g, t = _lanes()
    return np.stack([tile[m0 + g, k0 + t], tile[m0 + g + 8, k0 + t],
                     tile[m0 + g, k0 + t + 4], tile[m0 + g + 8, k0 + t + 4]],
                    axis=1)


def _load_b_nk(tile, n0, k0):
    g, t = _lanes()
    return np.stack([tile[n0 + g, k0 + t], tile[n0 + g, k0 + t + 4]], axis=1)


def _load_b_kn(tile, k0, n0):
    g, t = _lanes()
    return np.stack([tile[k0 + 2 * t, n0 + g], tile[k0 + 2 * t + 1, n0 + g]],
                    axis=1)


def _a_from_acc(c):
    return c[:, [0, 2, 1, 3]]


def _unfrag(c):
    """C fragments [32, 4] -> the 16 x 8 tile."""
    g, t = _lanes()
    out = np.zeros((16, 8))
    out[g, 2 * t], out[g, 2 * t + 1] = c[:, 0], c[:, 1]
    out[g + 8, 2 * t], out[g + 8, 2 * t + 1] = c[:, 2], c[:, 3]
    return out


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fragment_maps_compose_to_the_passes_products(d):
    """A warp's 16 rows against a 32-row tile: S = Q K^T from load_a and
    load_b_nk over d in steps of 8, then dQ = S K from a_from_acc (the
    accumulator's columns as k in the order 0, 2, .., 7) and load_b_kn
    (K's rows in the same order), as dq_f32_kernel (and, with K, V for Q,
    dO, dkv_f32_kernel) takes them."""
    rng = np.random.default_rng(d)
    qs, ks = rng.standard_normal((64, d)), rng.standard_normal((32, d))
    wr = 16
    s = []
    for j in range(4):
        c = np.zeros((32, 4))
        for kk in range(0, d, 8):
            c += _mma(_load_a(qs, wr, kk), _load_b_nk(ks, 8 * j, kk))
        s.append(c)
    np.testing.assert_allclose(np.hstack([_unfrag(c) for c in s]),
                               qs[wr:wr + 16] @ ks.T, rtol=1e-12)
    dq = np.zeros((16, d))
    for n in range(d // 8):
        c = np.zeros((32, 4))
        for j in range(4):
            c += _mma(_a_from_acc(s[j]), _load_b_kn(ks, 8 * j, 8 * n))
        dq[:, 8 * n:8 * n + 8] = _unfrag(c)
    np.testing.assert_allclose(dq, (qs[wr:wr + 16] @ ks.T) @ ks, rtol=1e-10)


def _ldsm_rows(kind, ld, r0, k0):
    """The float offset each lane gives ldmatrix .x4 in load_a (rows r0 +
    r + 8 (i % 2), column k0 + 4 (i / 2)) or load_b_nk2 (rows r0 + r + 8
    (i / 2), column k0 + 4 (i % 2)), lane 8 i + r."""
    lane = np.arange(32)
    i, r = lane >> 3, lane & 7
    if kind == "a":
        return (r0 + r + 8 * (i & 1)) * ld + k0 + 4 * (i >> 1)
    return (r0 + r + 8 * (i >> 1)) * ld + k0 + 4 * (i & 1)


def _ldsm_x4(flat, rows):
    """ldmatrix .x4 .b16 on f32 data: register i of lane 4 g + t is the
    32-bit word t of row g of matrix i, whose rows lanes 8 i .. give."""
    g, t = _lanes()
    return np.stack([flat[rows[8 * i + g] + t] for i in range(4)], axis=1)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_ldmatrix_rows_give_the_fragments(d):
    """load_a's and load_b_nk2's row addresses, through ldmatrix, give the
    A fragment of rows m0 .. m0 + 15 and the B fragments of the 8-row tiles
    n0 and n0 + 8, in a tile of rows d + 4 apart."""
    ld = d + 4
    tile = np.random.default_rng(d).standard_normal((64, ld))
    flat = tile.reshape(-1)
    for r0 in (0, 16, 48):
        for k0 in range(0, d, 8):
            np.testing.assert_array_equal(
                _ldsm_x4(flat, _ldsm_rows("a", ld, r0, k0)),
                _load_a(tile, r0, k0))
            np.testing.assert_array_equal(
                _ldsm_x4(flat, _ldsm_rows("b", ld, r0, k0)),
                np.hstack([_load_b_nk(tile, r0, k0),
                           _load_b_nk(tile, r0 + 8, k0)]))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fragment_loads_are_conflict_free(d):
    """At rows d + 4 floats apart, the eight 16-byte rows of each ldmatrix
    matrix (load_a, load_b_nk2) fall in eight distinct 16-byte bank groups,
    and each 32-bit load of load_b_kn in 32 distinct banks."""
    ld = d + 4
    g, t = _lanes()
    for r0 in (0, 16, 48):
        for k0 in range(0, d, 8):
            for kind in ("a", "b"):
                rows = _ldsm_rows(kind, ld, r0, k0)
                for i in range(4):
                    groups = (rows[8 * i:8 * i + 8] * 4 // 16) % 8
                    assert len(set(groups.tolist())) == 8
            for off in ((2 * t) * ld + g, (2 * t + 1) * ld + g):
                assert len(set(((r0 * ld + k0 + off) % 32).tolist())) == 32


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_bit_shuffles_reach_their_elements(rate):
    """Pass 1: lane l draws keep_bits16 of row l / 2's keys 16 (l % 2) ..
    of the tile, a thread takes rows g and g + 8 as the words of lanes 2r
    and 2r + 1; pass 2: lane l draws the warp's 16 keys of query l, a
    thread takes query 8 j + 2t + h from lane 8 j + 2t + h. Each
    accumulator element (row g + 8 (e / 2), column 8 j + 2t + e % 2) then
    reads the bit of its own (query, key) of nn.keep_mask."""
    n, seed = 1001, 1234
    q, _ = nn.keep_threshold(rate)
    mask = nn.keep_mask(seed, (1, 1, n, n), rate).numpy()[0, 0]
    flat = nn.random_bytes(seed, 0, n * n).numpy()

    def keep16(i0):
        return sum(int(flat[i0 + j] < q) << j for j in range(16)
                   if i0 + j < n * n)

    g, t = _lanes()
    q0, key0 = 48, 320                 # a warp's rows 48 .., key tile 320
    mine = [keep16((q0 + (lane >> 1)) * n + key0 + 16 * (lane & 1))
            for lane in range(32)]
    for lane in range(32):
        for i in range(2):
            r = g[lane] + 8 * i
            kept = mine[2 * r] | mine[2 * r + 1] << 16
            for j in range(4):
                for e in range(2):
                    c = 8 * j + 2 * t[lane] + e
                    assert (kept >> c) & 1 == mask[q0 + r, key0 + c]
    kw, qt0 = 656, 960                 # a warp's keys 656 .., query tile 960
    mine = [keep16((qt0 + lane) * n + kw) if qt0 + lane < n else 0
            for lane in range(32)]
    for lane in range(32):
        for j in range(4):
            for e in range(4):
                col = 8 * j + 2 * t[lane] + (e & 1)
                key = g[lane] + 8 * (e >> 1)
                if qt0 + col < n:
                    assert (mine[col] >> key) & 1 == mask[qt0 + col, kw + key]


def test_variants_script_replaces_text_of_the_sources():
    """scripts/torch_attention_bwd_f32_variants.py builds each variant by
    replacing lines of the sources: each replaced text is in them, once
    where it must be unique, and each variant changes something."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_attention_bwd_f32_variants.py"
    spec = importlib.util.spec_from_file_location("variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    this = mod.sources_of("this")
    for name, subs in mod.VARIANTS.items():
        texts = mod.sources_of(name)
        assert (texts != this) == bool(subs), name
        for fname, old, _ in subs:
            assert this[fname].count(old) == 1, (name, old[:40])
