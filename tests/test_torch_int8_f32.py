"""The f32 instances of the int8 serving kernels K10-K13 as far as the CPU
reaches them: K13 f32's launch plan (``ops/int8_serving.py``
``int8_attn_f32_plan``) as a pure function, its refusals those of the
bf16 K13's plan; what each f32 wrapper hands its C entry point (symbol,
scratch, scalars) against its bf16 twin, with the launch recorded instead
of run; the dispatch of f32, bf16 and other card tensors
(``common.pick``); and a model in plain torch index arithmetic of K13
f32's walk (``csrc/int8_attention_f32.cu``): the two sweeps over 32-key
tiles, each row's max from sweep 0, p's codes written into the P8 tile at
the positions the prologue's v8 keeps its keys' codes, the v8 tile's
swapped halves, and the four-key dot products of ``__dp4a`` over stored
positions. Its codes and int32 sums must equal ``attn_codes``' and
p8 . v8 bit for bit, at N = 1001 with n_valid = N and n_valid < N.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import common
from neurovit_tpu_torch.ops import int8_serving as q8
from neurovit_tpu_torch.ops.common import SMEM_LIMIT
from neurovit_tpu_torch.ops.flash_attention import LOG2E, SCORE_CAP

N = 1001


# ---------------------------------------------------------------------------
# K13 f32's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 8, 32])
def test_f32_attn_plan_at_the_flagship(b):
    """64 query rows a block of 128 threads, 32-key tiles; shared memory the
    Q tile and two K tiles of f32, two v8 tiles and the P8 tile; the
    prologue and the scratch the bf16 K13's."""
    plan = q8.int8_attn_f32_plan(b, N, 8, 64)
    bf16 = q8.int8_attn_plan(b, N, 8, 64)
    assert (plan.d_kernel, plan.bq, plan.bkv) == (64, 64, 32)
    assert plan.launches[:2] == bf16.launches[:2]
    assert (plan.n_pad, plan.v8_bytes, plan.stats_bytes) == (
        bf16.n_pad, bf16.v8_bytes, bf16.stats_bytes)
    name, grid, threads, smem = plan.launches[2]
    assert (name, grid, threads) == ("attention", (16 * b * 8,), 128)
    assert smem == 64 * 64 * 4 + 2 * 32 * 64 * 4 + 2 * 64 * 32 + 64 * 32


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("b", [1, 8])
def test_f32_attn_plan_at_every_width(width, b):
    _, heads, dh, _ = WIDTHS[width]
    plan = q8.int8_attn_f32_plan(b, N, heads, dh)
    assert plan.d_kernel == (64 if dh <= 64 else 128)
    d = plan.d_kernel
    assert plan.launches[2][3] == (64 + 64) * d * 4 + 64 * d + 2048
    assert plan.launches[2][3] <= SMEM_LIMIT
    assert plan.v8_bytes == b * heads * d * plan.n_pad


@pytest.mark.parametrize("shape", [(1, N, 8, 160), (1, N, 8, 4),
                                   (2 ** 16, 2 ** 12, 2 ** 4, 64),
                                   (2 ** 14, 16, 2 ** 11, 128)])
def test_f32_attn_plan_refuses_what_bf16_refuses(shape):
    with pytest.raises(ValueError) as bf16:
        q8.int8_attn_plan(*shape)
    with pytest.raises(ValueError) as f32:
        q8.int8_attn_f32_plan(*shape)
    assert str(f32.value) == str(bf16.value)


def test_f32_attn_plan_past_65535_heads():
    plan = q8.int8_attn_f32_plan(8193, 16, 8, 16)
    assert plan.launches[2][1] == (8193 * 8,)


# ---------------------------------------------------------------------------
# The wrappers' launches, recorded
# ---------------------------------------------------------------------------

def _operands(rng, dtype, m=(2, 5), dim=64, heads=2, dh=32, hid=128):
    def t(*shape, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape), dtype=dt)

    def w8(out_f, in_f):
        return q8.quantize_weight(t(out_f, in_f))

    x, a = t(*m, dim, dt=dtype), t(*m, heads * dh, dt=dtype)
    q = [t(*m, heads, dh, dt=dtype) for _ in range(3)]
    ln = (t(dim), t(dim))
    return {
        "int8_ln_qkv": (x, *ln, *w8(3 * heads * dh, dim), heads, dh),
        "int8_outproj_residual": (x, a, *w8(dim, heads * dh), t(dim)),
        "int8_mlp_block": (x, *ln, *w8(hid, dim), t(hid), *w8(dim, hid),
                           t(dim)),
        "int8_flash_attention": tuple(q),
    }


def _recorded(monkeypatch, name, dtype):
    """What the ``name`` wrapper of ``dtype`` hands its C entry point, with
    the operand checks and the launch replaced by records: (symbol,
    argtypes, the scratch tensors' sizes, the scalars)."""
    seen = []
    monkeypatch.setattr(q8, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(q8, "_check_qkv", lambda *a, **k: None)
    monkeypatch.setattr(q8, "launch", lambda symbol, argtypes, like, *args:
                        seen.append((symbol, argtypes, args)))
    sizes = []
    empty = torch.empty

    def spy(*shape, **kw):
        out = empty(*shape, **kw)
        sizes.append(out.numel() * out.element_size())
        return out

    monkeypatch.setattr(torch, "empty", spy)
    fn = getattr(q8, name + ("_f32_cuda" if dtype == torch.float32
                             else "_cuda"))
    # The stubbed launch still counts: restore the counter after the test.
    monkeypatch.setattr(fn, "launches", fn.launches)
    args = _operands(np.random.default_rng(0), dtype)[name]
    before = fn.launches
    if name == "int8_flash_attention":
        fn(*args, scale=0.25, n_valid=4)
    else:
        fn(*args)
    monkeypatch.setattr(torch, "empty", empty)
    assert fn.launches == before + 1
    (symbol, argtypes, raw), = seen
    scalars = [v for v in raw if not hasattr(v, "value")]
    return symbol, argtypes, sizes, scalars


@pytest.mark.parametrize("name", ["int8_ln_qkv", "int8_outproj_residual",
                                  "int8_mlp_block", "int8_flash_attention"])
def test_f32_wrappers_launch_as_bf16(monkeypatch, name):
    """Each f32 wrapper calls its own ``*_f32`` entry point with the
    argument types, scratch bytes and scalars its bf16 twin passes: the
    plans of K10-K12 are shared, K13's scratch is the bf16 K13's."""
    bf16 = _recorded(monkeypatch, name, torch.bfloat16)
    f32 = _recorded(monkeypatch, name, torch.float32)
    symbols = {"int8_ln_qkv": "nvt_int8_ln_qkv",
               "int8_outproj_residual": "nvt_int8_outproj",
               "int8_mlp_block": "nvt_int8_mlp",
               "int8_flash_attention": "nvt_int8_attention"}
    assert bf16[0] == symbols[name] and f32[0] == symbols[name] + "_f32"
    assert f32[1:] == bf16[1:]


def test_f32_wrappers_count_their_own_launches(monkeypatch):
    """A launch of an f32 wrapper counts on it alone."""
    counted = [getattr(q8, n + s) for n in ("int8_ln_qkv",
                                            "int8_outproj_residual",
                                            "int8_mlp_block",
                                            "int8_flash_attention")
               for s in ("_cuda", "_f32_cuda")]
    before = [fn.launches for fn in counted]
    _recorded(monkeypatch, "int8_mlp_block", torch.float32)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [
        0, 0, 0, 0, 0, 1, 0, 0]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "_f32_cuda"), (torch.bfloat16, "_cuda"),
    (torch.float16, "_cuda")])
def test_dispatch_on_card_tensors(monkeypatch, dtype, kernel):
    """With operands taken as on the card: f32 picks each int8 op's f32
    kernel, bf16 its bf16 kernel, and any other dtype the bf16 kernel,
    which raises for it (there is no fallback); CPU tensors the plain
    version."""
    ops = _operands(np.random.default_rng(1), dtype)
    called = []
    for name in ops:
        for suffix in ("_plain", "_cuda", "_f32_cuda"):
            monkeypatch.setattr(q8, name + suffix,
                                lambda *a, _n=name + suffix, **k:
                                called.append(_n))
    for name, args in ops.items():
        kw = {"scale": 0.2} if name == "int8_flash_attention" else {}
        getattr(q8, name)(*args, **kw)
    assert called == [n + "_plain" for n in ops]
    called.clear()
    monkeypatch.setattr(common, "on_cpu", lambda *_: False)
    for name, args in ops.items():
        kw = {"scale": 0.2} if name == "int8_flash_attention" else {}
        getattr(q8, name)(*args, **kw)
    assert called == [n + kernel for n in ops]


# ---------------------------------------------------------------------------
# K13 f32's walk
# ---------------------------------------------------------------------------

BQ, BKV, THREADS = q8.ATTN_F32_BQ, q8.ATTN_F32_BKV, q8.ATTN_F32_THREADS


def _p8_position(tx: torch.Tensor) -> torch.Tensor:
    """The kernel's p8_position: the byte of a P8 row holding key tx * 4."""
    return 16 * (tx // 4) + 8 * (tx % 2) + 2 * ((tx // 2) % 2)


def test_p8_positions_are_v8s():
    """A thread's keys tx * 4 + j land at p8_position(tx) + (0, 1, 4, 5)[j],
    the stored position v8_key_order gives each key: a bijection of each
    row's 32 positions."""
    tx = torch.arange(8)[:, None]
    pos = _p8_position(tx) + torch.tensor([0, 1, 4, 5])
    order = q8.v8_key_order(32)                 # position -> key
    assert torch.equal(order[pos], tx * 4 + torch.arange(4))
    assert torch.equal(pos.flatten().sort().values, torch.arange(32))


def test_v8_tile_halves_are_conflict_free():
    """The v8 tile's row d keeps its half h at 16 (h ^ ((d / 4) % 2)): a
    bijection, and the 8 lanes of a quarter-warp (channels tx + 8 c) read
    16-byte pieces of 32 distinct banks."""
    d = torch.arange(128)[:, None]
    h = torch.arange(2)
    at = 32 * d + 16 * (h ^ ((d // 4) % 2))
    assert torch.equal(at.flatten().sort().values,
                       torch.arange(0, 128 * 32, 16))
    for c in range(16):
        for half in range(2):
            lanes = torch.arange(8) + 8 * c
            start = 32 * lanes + 16 * (half ^ ((lanes // 4) % 2))
            banks = (start[:, None] // 4 + torch.arange(4)) % 32
            assert banks.flatten().unique().numel() == 32


def _walk(q, k, v, scale, n_valid):
    """K13 f32's walk over [1, N, H, D] f32 operands in index arithmetic:
    (p8 [H, N, N] in key order, the int32 sums [H, N, D]), with the
    scores taken from the plain version (the kernel's own sums are another
    order of the same products; both sweeps use one function)."""
    b, n, h, d = q.shape
    qf, kf, vf = (x.permute(0, 2, 1, 3).float()[0] for x in (q, k, v))
    t = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    n_tiles = -(-n_valid // BKV)
    tx = torch.arange(THREADS) % 8
    ty = torch.arange(THREADS) // 8
    rows = ty[:, None] * 4 + torch.arange(4)                 # [T, 4]
    # Sweep 0: each row's max of t over the thread's keys of every tile.
    m = torch.full((h, n), -torch.finfo(torch.float32).max)
    covered = torch.zeros(n, dtype=torch.long)
    for kt in range(n_tiles):
        keys = kt * BKV + tx[:, None] * 4 + torch.arange(4)  # [T, 4]
        for tq in range(-(-n // BQ)):
            r = (tq * BQ + rows).clamp(max=n - 1)            # [T, 4]
            vals = t[:, r[:, :, None], keys[:, None, :].clamp(max=n - 1)]
            valid = (keys < n_valid)[:, None, :].expand_as(vals[0])
            vals = torch.where(valid, vals, torch.tensor(-np.inf))
            m.scatter_reduce_(1, r.flatten().expand(h, -1),
                              vals.amax(-1).reshape(h, -1), "amax")
        row_keys = keys[:8]              # one row's keys: the lanes tx
        live = row_keys[row_keys < n_valid]
        covered.index_add_(0, live, torch.ones_like(live))
    assert torch.equal(covered, (torch.arange(n) < n_valid).long())
    s_p = q8._scale(torch.exp2(torch.clamp(m, -SCORE_CAP, SCORE_CAP)))
    # Sweep 1: p, its codes into the P8 tile at v8's positions, and the
    # four-key products of the tile's stored positions.
    p = torch.exp2(torch.clamp(t, -SCORE_CAP, SCORE_CAP))
    p = p * (torch.arange(n) < n_valid).float()
    p8 = torch.clamp(torch.round(p / s_p[..., None]), 0, 127)
    n_pad = -(-n // 64) * 64
    order = q8.v8_key_order(n_pad)
    s_v = q8._scale(vf[:, :n_valid].abs().amax(dim=1, keepdim=True))
    codes = torch.clamp(torch.round(vf / s_v), -127, 127)
    stored = torch.zeros(h, n_pad, d)
    stored[:, :n_valid] = codes[:, :n_valid]
    v8 = stored[:, order].transpose(1, 2).long()             # [H, D, n_pad]
    pos = (_p8_position(tx)[:, None] + torch.tensor([0, 1, 4, 5]))
    acc = torch.zeros(h, n, d, dtype=torch.long)
    rows_n = -(-n // BQ) * BQ
    p8_pad = torch.zeros(h, rows_n, n_pad, dtype=torch.long)
    p8_pad[:, :n, :n] = p8.long()
    for kt in range(n_tiles):
        tile = torch.full((h, rows_n, BKV), -1, dtype=torch.long)
        keys = kt * BKV + tx[:, None] * 4 + torch.arange(4)
        for tq in range(rows_n // BQ):
            r = tq * BQ + rows                                # [T, 4]
            tile[:, r[:, :, None], pos[:, None, :]] = \
                p8_pad[:, r[:, :, None], keys[:, None, :]]
        assert (tile >= 0).all()                  # every position written
        vt = v8[:, :, kt * BKV:(kt + 1) * BKV]
        for w in range(BKV // 4):                 # one __dp4a a word
            acc += torch.einsum("hrk,hdk->hrd", tile[:, :n, 4 * w:4 * w + 4],
                                vt[:, :, 4 * w:4 * w + 4])
    return p8, acc


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_valid", [1, 31, 33, 97, 900, N])
def test_walk_gives_attn_codes_and_p8_v8(n_valid, d):
    rng = np.random.default_rng(100 * d + n_valid)
    q, k, v = (torch.tensor(rng.standard_normal((1, N, 2, d)),
                            dtype=torch.float32) for _ in range(3))
    p8, acc = _walk(q, k, v, d ** -0.5, n_valid)
    want_p8, want_v8, *_ = q8.attn_codes(q, k, v, d ** -0.5, n_valid)
    assert torch.equal(p8, want_p8[0])
    want = (want_p8[0].double() @ want_v8[0].double()).long()
    assert torch.equal(acc, want)


# ---------------------------------------------------------------------------
# K13 f32's quotient for the codes
# ---------------------------------------------------------------------------

def _rn32(x) -> np.float32:
    """The f32 nearest the exact rational x, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        err = abs(Fraction(float(c)) - x)
        even = int(np.array(c, np.float32).view(np.uint32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, c)
    return best[1]


def _fma32(a, b, c) -> np.float32:
    from fractions import Fraction
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_quotient_is_the_ieee_quotient():
    """The kernel's quotient(a, b, RN(1 / b)) -- a product, then one
    correction by the exact remainder -- equals RN(a / b) bit for bit for
    the codes' operands: p in (2^-96, 2^96], s_p = RN(pmax / 127) for a
    pmax >= p, at random and at quotients next to each half-integer k +
    0.5 (the rounding boundaries of the codes), wherever a / b >= 2^-2."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    pmax = np.exp2(rng.uniform(-90, 96, 3000)).astype(np.float32)
    s_p = np.array([_rn32(Fraction(float(m)) / 127) for m in pmax],
                   np.float32)
    p = (pmax * rng.uniform(0.002, 1, 3000)).astype(np.float32)
    k = rng.integers(0, 127, 3000)
    near = np.array([_rn32((Fraction(int(kk)) + Fraction(1, 2))
                           * Fraction(float(s))) for kk, s in zip(k, s_p)],
                    np.float32)
    steps = rng.integers(-2, 3, 3000)
    for _ in range(2):
        near = np.where(steps > 0, np.nextafter(near, np.float32(np.inf)),
                        np.where(steps < 0,
                                 np.nextafter(near, np.float32(0)), near))
        steps = steps - np.sign(steps)
    checked = 0
    for a_all in (p, near):
        for a, b in zip(a_all, s_p):
            want = _rn32(Fraction(float(a)) / Fraction(float(b)))
            if want < 0.25:
                continue
            inv = _rn32(1 / Fraction(float(b)))
            q = np.float32(a) * inv                    # RN(a * inv_b)
            got = _fma32(_fma32(-q, b, a), inv, q)
            assert got == want, (a, b)
            checked += 1
    assert checked > 4000


@pytest.mark.parametrize("name", ["int8_ln_qkv", "int8_outproj_residual",
                                  "int8_mlp_block"])
def test_f32_wrappers_take_a_caller_scratch(monkeypatch, name):
    """K10-K12 at f32 hand a caller's scratch to their entry point in place
    of one of their own (so its codes and row scales can be read after the
    call), and refuse one smaller than the plan's bytes."""
    seen = []
    monkeypatch.setattr(q8, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(q8, "launch", lambda symbol, argtypes, like, *args:
                        seen.append(args))
    fn = getattr(q8, name + "_f32_cuda")
    monkeypatch.setattr(fn, "launches", fn.launches)
    args = _operands(np.random.default_rng(2), torch.float32)[name]
    x = args[0]
    m, dim = x.numel() // x.shape[-1], x.shape[-1]
    plan = (q8.qkv_plan(m, dim, args[5] * args[6])
            if name == "int8_ln_qkv" else
            q8.int8_outproj_plan(m, dim, args[1].shape[-1])
            if name == "int8_outproj_residual" else
            q8.mlp_plan(m, dim, args[3].shape[0]))
    scratch = torch.zeros(plan.scratch_bytes, dtype=torch.uint8)
    fn(*args, scratch=scratch)
    (raw,) = seen
    assert scratch.data_ptr() in [getattr(v, "value", None) for v in raw]
    with pytest.raises(ValueError, match="scratch"):
        fn(*args, scratch=scratch[:plan.scratch_bytes - 1])


# ---------------------------------------------------------------------------
# K13 f32's bound (chip_smoke.py's hold_int8_attn_f32, the card's check)
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scores_in_f64(q, k, v, scale, n_valid):
    """The plain K13 with each score summed in f64 and rounded once: the
    scores of a correct kernel that sums along D in another order."""
    qf, kf, vf = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = torch.matmul(qf.double(), kf.double().transpose(-1, -2)).float()
    p = torch.exp2(torch.clamp(s * (scale * LOG2E), -SCORE_CAP, SCORE_CAP))
    p = p * (torch.arange(q.shape[1]) < n_valid).float()
    s_p = q8._scale(p.amax(dim=-1, keepdim=True))
    p8 = torch.clamp(torch.round(p / s_p), 0, 127)
    s_v = q8._scale(vf[:, :, :n_valid].abs().amax(dim=2, keepdim=True))
    v8 = torch.clamp(torch.round(vf / s_v), -127, 127)
    acc = torch.matmul(p8.double(), v8.double()).float()
    o = acc * (s_p / p.sum(dim=-1, keepdim=True) * s_v)
    return o.permute(0, 2, 1, 3).contiguous()


@pytest.mark.parametrize("n_valid", [N, 900])
@pytest.mark.parametrize("variant", ["scores in f64", "QK^T in TF32",
                                     "the denominator from the codes"])
def test_attn_f32_bound_sees_the_faults(n_valid, variant):
    """K13 f32's bound at the flagship's N and head dim over 4 heads:
    scores summed in another order (f64, rounded once) flip a few codes
    and stay within the allowance of rows outside F32_TOL (1 + |plain|);
    QK^T in TF32 and the denominator from the codes, each within the bf16
    int8 bound somewhere, put many times the allowance outside."""
    cs = _chip_smoke()
    rng = np.random.default_rng(67)
    q, k, v = (torch.tensor(rng.standard_normal((1, N, 4, 64)),
                            dtype=torch.float32) for _ in range(3))
    kw = {"scale": 64 ** -0.5, "n_valid": n_valid}
    want = q8.int8_flash_attention_plain(q, k, v, **kw)
    rows = N * 4
    allowed = int(cs.INT8_F32_ATTN_ROW_FRAC * rows)
    if variant == "scores in f64":
        got = _scores_in_f64(q, k, v, **kw)
        over = cs.hold_int8_attn_f32(variant, got, want)
        assert 0 < over <= allowed
    else:
        got = cs.int8_attn_faults(q, k, v, **kw)[variant]
        over, n, _ = cs.int8_attn_f32_rows(got, want)
        assert n == rows and over > 10 * allowed, over
        with pytest.raises(AssertionError, match="query rows outside"):
            cs.hold_int8_attn_f32(variant, got, want)
