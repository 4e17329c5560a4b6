"""The f32 instances of the int8 serving kernels K10-K13 as far as the CPU
reaches them: K13 f32's launch plan (``ops/int8_serving.py``
``int8_attn_f32_plan``) as a pure function, its refusals those of the
bf16 K13's plan; what each f32 wrapper hands its C entry point (symbol,
scratch, scalars) against its bf16 twin, with the launch recorded instead
of run; the dispatch of f32, bf16 and other card tensors
(``common.pick``); and models of K13 f32 (``csrc/int8_attention_f32.cu``):

- its walk on ``mma.sync``'s fragments in torch index arithmetic: the two
  sweeps over 32-key ring steps, each row's max from sweep 0 by the quad,
  the S accumulator's codes packed by ``P8_PACK`` into the A registers of
  ``m16n8k32.s8`` and the B registers read from the 32-byte-swizzled v8
  box. Its codes and int32 sums must equal ``attn_codes``' p8 and p8 . v8
  bit for bit, at N = 1001 with n_valid on and off the steps; the B loads
  fall in 32 distinct banks;
- its 3xTF32 scores (``tf32x3.cuh``'s split, each MMA's sum rounded
  toward zero, a fresh accumulator every k8 step added in f32), held to
  ``chip_smoke.py``'s ``hold_int8_attn_f32`` at half its allowance, and
  one accumulator over D = 128, which that bound must refuse; with the
  row max's score and the scores near a code's rounding boundary taken
  again in the plain version's order, its codes and s_p are plain's bit
  for bit;
- the call-free quotient of its codes, and the bound's two faulty plain
  versions.
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
    """64 query rows a block of 128 threads (four warps of 16), 32-key ring
    steps, three stages; shared memory the f32 Q box, three f32 K boxes,
    three v8 boxes and seven barriers after 1 KiB of alignment slack, each
    box on 1024 bytes; the prologue and the scratch the bf16 K13's."""
    plan = q8.int8_attn_f32_plan(b, N, 8, 64)
    bf16 = q8.int8_attn_plan(b, N, 8, 64)
    assert (plan.d_kernel, plan.bq, plan.bkv, plan.stages) == (64, 64, 32, 3)
    assert plan.launches[:2] == bf16.launches[:2]
    assert (plan.n_pad, plan.v8_bytes, plan.stats_bytes) == (
        bf16.n_pad, bf16.v8_bytes, bf16.stats_bytes)
    name, grid, threads, smem = plan.launches[2]
    assert (name, grid, threads) == ("attention", (16 * b * 8,), 128)
    assert plan.offsets == (0, 64 * 64 * 4, 64 * 64 * 4 + 3 * 32 * 64 * 4,
                            64 * 64 * 4 + 3 * 32 * 64 * 5)
    assert all(at % 1024 == 0 for at in plan.offsets[:3])
    assert smem == 1024 + plan.offsets[3] + 7 * 8
    assert 2 * (smem + 1024) <= 228 * 1024      # two blocks an SM


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("b", [1, 8])
def test_f32_attn_plan_at_every_width(width, b):
    _, heads, dh, _ = WIDTHS[width]
    plan = q8.int8_attn_f32_plan(b, N, heads, dh)
    assert plan.d_kernel == (64 if dh <= 64 else 128)
    d = plan.d_kernel
    assert plan.launches[2][3] == 1024 + 64 * d * 4 + 3 * 32 * d * 5 + 56
    assert plan.launches[2][3] <= SMEM_LIMIT
    assert 2 * (plan.launches[2][3] + 1024) <= 228 * 1024   # two an SM
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
# K13 f32's walk on mma.sync's fragments
# ---------------------------------------------------------------------------

BQ, BKV = q8.ATTN_F32_BQ, q8.ATTN_F32_BKV
LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4          # lane = 4 g + t
E, J = torch.arange(4), torch.arange(4)
# mma.sync.m16n8k32.s8 (PTX ISA): byte b of A register r of lane (g, t) is
# A[g + 8 (r % 2), 4 t + b + 16 (r // 2)]; byte b of B register r is
# B[4 t + b + 16 r, g]; [32 lanes, 4 registers, 4 bytes] each.
_R, _B = torch.arange(4)[:, None], torch.arange(4)[None, :]
A_ROW = (G[:, None, None] + 8 * (_R % 2)[None]).expand(32, 4, 4)
A_COL = 4 * T[:, None, None] + _B[None] + 16 * (_R // 2)[None]
B_K = 4 * T[:, None, None] + _B[None] + 16 * _R[None, :2]
B_N = G[:, None, None].expand(32, 2, 4)


def _v8_box(tile: torch.Tensor) -> torch.Tensor:
    """A v8 box as TMA writes it with the 32-byte swizzle: [..., D, 32]
    (channel rows of 32 stored key bytes) -> [..., D * 32] bytes, byte c of
    row d at 32 d + (c ^ 16 ((d / 4) % 2))."""
    *lead, d, _ = tile.shape
    rows, c = torch.arange(d)[:, None], torch.arange(32)[None, :]
    at = (32 * rows + (c ^ (16 * ((rows // 4) % 2)))).reshape(-1)
    box = torch.zeros(*lead, d * 32, dtype=tile.dtype)
    box[..., at] = tile.reshape(*lead, -1)
    return box


def _b_words(d: int) -> tuple:
    """The 32-bit words of the v8 box that lane (g, t) loads as the B of
    channel tile n, the kernel's 64 n + v0 and 64 n + v1: [D / 8, 32]
    each."""
    sw = G & 4
    n = torch.arange(d // 8)[:, None]
    return 64 * n + 8 * G + (T ^ sw), 64 * n + 8 * G + ((4 + T) ^ sw)


def test_fragment_layouts_are_bijections():
    """The A map covers the 16 x 32 A tile once and the B map the 32 x 8 B
    tile once; P8_PACK takes each of a thread's 16 accumulator values of a
    step once, and the A map then puts row g's keys 2 t, 2 t + 1, 8 + 2 t,
    9 + 2 t (then 16 + ..) at the stored positions v8_key_order gives
    them."""
    assert sorted((A_ROW * 32 + A_COL).reshape(-1).tolist()) == list(
        range(512))
    assert sorted((B_K * 8 + B_N).reshape(-1).tolist()) == list(range(256))
    pack = torch.tensor(q8.P8_PACK)
    assert sorted(pack.reshape(-1).tolist()) == list(range(16))
    # acc[4 j + e]: row g + 8 (e // 2), key 8 j + 2 t + e % 2.
    key = (8 * (pack // 4) + 2 * T[:, None, None] + pack % 2)
    row = G[:, None, None] + 8 * (pack % 4 // 2)
    assert torch.equal(row, A_ROW)
    assert torch.equal(q8.v8_key_order(32)[A_COL], key)


def _mma_walk(q, k, v, scale, n_valid):
    """K13 f32's walk over [1, N, H, D] f32 operands on mma.sync's
    fragments: (the codes p8 [H, N, N] in key order as the A fragments
    carry them, the int32 sums [H, N, D] of the s8 MMAs). Every warp's 16
    rows of every query tile, both sweeps over the 32-key steps below
    n_valid; the scores are plain's (the kernel's are another order of
    the same products; both sweeps use one function), zero on rows past N
    as TMA fills Q."""
    _, n, h, d = q.shape
    qf, kf, vf = (x.permute(0, 2, 1, 3).float()[0] for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    n_tiles, q_tiles = -(-n_valid // BKV), -(-n // BQ)
    rows_n, keys_n = q_tiles * BQ, n_tiles * BKV
    t_all = torch.zeros(h, rows_n, keys_n)
    t_all[:, :n, :min(n, keys_n)] = s[:, :, :keys_n]
    r0 = (BQ * torch.arange(q_tiles)[:, None]
          + 16 * torch.arange(4)).reshape(-1)                 # warps' rows
    w = r0.numel()
    rows = r0[:, None, None] + G[None, :, None] + 8 * (E // 2)  # [W, 32, 4]

    def frag(kt):
        """S of step kt: [H, W, 32 lanes, 4 j, 4 e], and the keys."""
        keys = (BKV * kt + 8 * J[None, :, None] + 2 * T[:, None, None]
                + (E % 2)[None, None, :])                      # [32, 4, 4]
        return t_all[:, rows[:, :, None, :], keys[None]], keys

    # Sweep 0: each lane's max of its masked t, then over the quad.
    m = torch.full((h, w, 32, 2), -np.inf)
    for kt in range(n_tiles):
        vals, keys = frag(kt)
        vals = torch.where(keys < n_valid, vals, torch.tensor(-np.inf))
        m = torch.maximum(m, vals.reshape(h, w, 32, 4, 2, 2).amax(dim=(3, 5)))
    m = m.reshape(h, w, 8, 4, 2).amax(dim=3)                  # [H, W, g, i]
    row_of = (r0[:, None, None] + torch.arange(8)[:, None]
              + 8 * torch.arange(2)).reshape(-1)
    m_rows = torch.empty(h, rows_n)
    m_rows[:, row_of] = m.reshape(h, -1)
    valid = torch.arange(n) < n_valid
    assert torch.equal(m_rows[:, :n], torch.where(
        valid, s, torch.tensor(-np.inf)).amax(-1))
    s_p = q8._scale(torch.exp2(torch.clamp(m_rows, -SCORE_CAP, SCORE_CAP)))

    # Sweep 1: the codes packed into A, B from the v8 box, C += A B.
    n_pad = -(-n // 64) * 64
    s_v = q8._scale(vf[:, :n_valid].abs().amax(dim=1, keepdim=True))
    stored = torch.zeros(h, n_pad, d, dtype=torch.long)
    stored[:, :n_valid] = torch.clamp(torch.round(vf / s_v), -127,
                                      127)[:, :n_valid].long()
    v8 = stored[:, q8.v8_key_order(n_pad)].transpose(1, 2)   # [H, D, n_pad]
    order = q8.v8_key_order(BKV)
    w0, w1 = _b_words(d)
    p8 = torch.zeros(h, rows_n, keys_n, dtype=torch.long)
    c = torch.zeros(h, w, d // 8, 16, 8, dtype=torch.long)
    for kt in range(n_tiles):
        vals, keys = frag(kt)
        p = torch.where(keys < n_valid,
                        torch.exp2(torch.clamp(vals, -SCORE_CAP, SCORE_CAP)),
                        torch.tensor(0.0))
        sp = s_p[:, rows][:, :, :, None, :]                   # over j
        code = torch.clamp(torch.round(p / sp), 0, 127).long()
        regs = code.reshape(h, w, 32, 16)[..., torch.tensor(q8.P8_PACK)]
        a = torch.zeros(h, w, 16, 32, dtype=torch.long)
        a[:, :, A_ROW, A_COL] = regs
        p8[:, r0[:, None, None] + torch.arange(16)[:, None],
           BKV * kt + order] = a
        box = _v8_box(v8[:, :, BKV * kt:BKV * (kt + 1)])     # [H, D * 32]
        b = torch.zeros(h, d // 8, 32, 8, dtype=torch.long)
        for r, words in enumerate((w0, w1)):
            b[:, :, B_K[:, r], B_N[:, r]] = box[:, 4 * words[..., None]
                                                + torch.arange(4)]
        c += torch.einsum("hwmk,hnkc->hwnmc", a, b)
    # C's fragment: c[2 i + x] of lane (g, t) is row g + 8 i, channel 8 n
    # + 2 t + x, written there.
    acc = torch.zeros(h, rows_n, d, dtype=torch.long)
    acc[:, r0[:, None] + torch.arange(16)] = c.permute(0, 1, 3, 2, 4).reshape(
        h, w, 16, d)
    return p8[:, :n], acc[:, :n]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_valid", [1, 31, 33, 97, 900, N])
def test_mma_walk_gives_attn_codes_and_p8_v8(n_valid, d):
    """The walk's codes are attn_codes' p8 bit for bit (0 past the last
    step), and its s8 MMAs' int32 sums are p8 . v8, at N = 1001 with n_valid
    on and off the 32-key steps."""
    rng = np.random.default_rng(100 * d + n_valid)
    q, k, v = (torch.tensor(rng.standard_normal((1, N, 2, d)),
                            dtype=torch.float32) for _ in range(3))
    p8, acc = _mma_walk(q, k, v, d ** -0.5, n_valid)
    want_p8, want_v8, *_ = q8.attn_codes(q, k, v, d ** -0.5, n_valid)
    keys = min(p8.shape[-1], N)
    assert torch.equal(p8[..., :keys].float(), want_p8[0, :, :, :keys])
    assert not p8[..., keys:].any() and not want_p8[0, :, :, keys:].any()
    want = (want_p8[0].double() @ want_v8[0].double()).long()
    assert torch.equal(acc, want)


@pytest.mark.parametrize("d", [64, 128])
def test_v8_box_b_loads_are_conflict_free(d):
    """TMA's 32-byte swizzle places each byte of the v8 box once; lane (g,
    t)'s two words of channel tile n hold channel 8 n + g's stored
    positions 4 t .. 4 t + 3 and 16 + 4 t .. (the s8 B fragment), and the
    32 lanes of each load fall in 32 distinct banks."""
    tile = torch.arange(d * 32).reshape(d, 32)
    box = _v8_box(tile)
    assert torch.equal(box.sort().values, torch.arange(d * 32))
    for r, words in enumerate(_b_words(d)):
        got = box[4 * words[..., None] + torch.arange(4)]    # [D/8, 32, 4]
        channel = 8 * torch.arange(d // 8)[:, None, None] + G[:, None]
        assert torch.equal(got, tile[channel, (4 * T + 16 * r)[:, None]
                                     + torch.arange(4)])
        for n in range(d // 8):
            assert (words[n] % 32).unique().numel() == 32


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


def _from_scores(q, k, v, scale, n_valid, s):
    """The plain K13 on the scores s [B, H, N, N] (f32) in place of its
    f32 matmul's, [B, N, H, D] out."""
    vf = v.permute(0, 2, 1, 3)
    p = torch.exp2(torch.clamp(s * (scale * LOG2E), -SCORE_CAP, SCORE_CAP))
    p = p * (torch.arange(q.shape[1]) < n_valid).float()
    s_p = q8._scale(p.amax(dim=-1, keepdim=True))
    p8 = torch.clamp(torch.round(p / s_p), 0, 127)
    s_v = q8._scale(vf[:, :, :n_valid].abs().amax(dim=2, keepdim=True))
    v8 = torch.clamp(torch.round(vf / s_v), -127, 127)
    acc = torch.matmul(p8.double(), v8.double()).float()
    o = acc * (s_p / p.sum(dim=-1, keepdim=True) * s_v)
    return o.permute(0, 2, 1, 3).contiguous()


def _scores_in_f64(q, k, v, scale, n_valid):
    """The plain K13 with each score summed in f64 and rounded once: the
    scores of a correct kernel that sums along D in another order."""
    qf, kf = (t.permute(0, 2, 1, 3) for t in (q, k))
    s = torch.matmul(qf.double(), kf.double().transpose(-1, -2)).float()
    return _from_scores(q, k, v, scale, n_valid, s)


def _split_tf32(x: torch.Tensor) -> tuple:
    """big = x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties
    away), small = x - big as the tensor cores read it (its top 19 bits):
    tf32x3.cuh's split."""
    bits = x.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    small = ((x - big).contiguous().view(torch.int32)
             & -0x2000).view(torch.float32)
    return big, small


def _to_f32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to f32 (an MMA's sum)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _scores_3xtf32(q, k, fresh: bool) -> torch.Tensor:
    """Q K^T [B, H, N, N] as K13 f32's scores() takes it on mma.sync: per
    k8 step small . big, big . small, big . big, each MMA's eight exact
    products added to its accumulator rounded toward zero; with ``fresh``
    each step into a fresh accumulator, added to the score in f32 to
    nearest, else one accumulator over all of D."""
    qf, kf = (t.permute(0, 2, 1, 3) for t in (q, k))
    (ab, as_), (bb, bs) = _split_tf32(qf), _split_tf32(kf.transpose(-1, -2))
    s = torch.zeros(qf.shape[:-1] + (kf.shape[2],))
    for k0 in range(0, qf.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        part = torch.zeros_like(s) if fresh else s
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            part = _to_f32_rz(part.double()
                              + x[..., sl].double() @ y[..., sl, :].double())
        s = s + part if fresh else part
    return s


def _qkv(d: int, seed: int = 67) -> list:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((1, N, 4, d)),
                         dtype=torch.float32) for _ in range(3)]


@pytest.mark.parametrize("n_valid", [N, 900])
@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_scores_hold_the_row_bound(d, n_valid):
    """K13 f32's scores modelled in 3xTF32 with a fresh accumulator every
    k8 step, the rest plain, at N 1001 over 4 heads: the query rows
    outside F32_TOL (1 + |plain|) within half of hold_int8_attn_f32's
    allowance, every element within ATOL + RTOL |plain|. Printed beside
    the rows that scores summed in f64 put outside."""
    cs = _chip_smoke()
    q, k, v = _qkv(d)
    kw = {"scale": d ** -0.5, "n_valid": n_valid}
    want = q8.int8_flash_attention_plain(q, k, v, **kw)
    got = _from_scores(q, k, v, s=_scores_3xtf32(q, k, fresh=True), **kw)
    over = cs.hold_int8_attn_f32("3xTF32, fresh every k8 step", got, want)
    f64, rows, _ = cs.int8_attn_f32_rows(_scores_in_f64(q, k, v, **kw), want)
    print(f"\nD {d}, n_valid {n_valid}: 3xTF32 fresh every k8 step {over}, "
          f"f64 scores {f64} of {rows} rows outside F32_TOL")
    assert over <= int(cs.INT8_F32_ATTN_ROW_FRAC * rows) // 2


# The kernel's window around a code's rounding boundary, as p / s_p = x
# times it (int8_attention_f32.cu near_boundary).
RECOMPUTE_WINDOW = 2.0 ** -17


@pytest.mark.parametrize("n_valid", [N, 900])
@pytest.mark.parametrize("d", [64, 128])
def test_recompute_gives_plain_codes(d, n_valid):
    """K13 f32's codes from its 3xTF32 scores, with the row max's score and
    every score whose x = p / s_p lies within x 2^-17 of a half-integer
    taken again in the plain version's order (modelled by plain's own
    scores), are attn_codes' p8 and s_p bit for bit, and o holds F32_TOL
    (1 + |plain|) on every query row. The 3xTF32 x lies within x 2^-18 of
    plain's, half the window; printed with the share of scores taken
    again."""
    cs = _chip_smoke()
    q, k, v = _qkv(d)
    scale = d ** -0.5
    kw = {"scale": scale, "n_valid": n_valid}
    qf, kf = (t.permute(0, 2, 1, 3) for t in (q, k))
    valid = torch.arange(N) < n_valid

    def probs(t):
        p = torch.exp2(torch.clamp(t, -SCORE_CAP, SCORE_CAP))
        return p * valid.float()
    t3 = _scores_3xtf32(q, k, fresh=True) * (scale * LOG2E)
    tp = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    first = torch.where(valid, t3, torch.tensor(-np.inf)).argmax(-1,
                                                                 keepdim=True)
    s_p = q8._scale(probs(tp).gather(-1, first))
    x3 = probs(t3) / s_p
    near = (x3 - torch.round(x3)).abs() >= 0.5 - x3 * RECOMPUTE_WINDOW
    p = torch.where(near, probs(tp), probs(t3))
    x = torch.where(near, probs(tp) / s_p, x3)
    p8 = torch.clamp(torch.round(x), 0, 127)
    want_p8, want_v8, want_sp, _, s_v = q8.attn_codes(q, k, v, **kw)
    assert torch.equal(s_p, want_sp) and torch.equal(p8, want_p8)
    xp = probs(tp) / s_p
    live = xp > 0
    drift = float(((x3 - xp).abs()[live] / xp[live]).max())
    print(f"\nD {d}, n_valid {n_valid}: |x3 - x| / x at most {drift:.3e}; "
          f"{float(near.float().mean()):.2e} of the scores taken again")
    assert drift <= RECOMPUTE_WINDOW / 2
    acc = torch.matmul(p8.double(), want_v8.double()).float()
    o = (acc * (s_p / p.sum(dim=-1, keepdim=True) * s_v)).permute(
        0, 2, 1, 3)
    want = q8.int8_flash_attention_plain(q, k, v, **kw)
    assert cs.hold_int8_attn_f32("3xTF32 with the recompute", o, want) == 0


@pytest.mark.parametrize("n_valid", [N, 900])
def test_one_accumulator_fails_the_row_bound(n_valid):
    """The same scores in one accumulator over D = 128 (an MMA rounds
    toward zero, so the score drifts one way) put more query rows outside
    F32_TOL than hold_int8_attn_f32 allows: the bound sees that fault."""
    cs = _chip_smoke()
    q, k, v = _qkv(128)
    kw = {"scale": 128 ** -0.5, "n_valid": n_valid}
    want = q8.int8_flash_attention_plain(q, k, v, **kw)
    got = _from_scores(q, k, v, s=_scores_3xtf32(q, k, fresh=False), **kw)
    over, rows, _ = cs.int8_attn_f32_rows(got, want)
    print(f"\nD 128, n_valid {n_valid}: one accumulator {over} of {rows} "
          f"rows outside F32_TOL")
    assert over > int(cs.INT8_F32_ATTN_ROW_FRAC * rows)
    with pytest.raises(AssertionError, match="query rows outside"):
        cs.hold_int8_attn_f32("one accumulator", got, want)


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


def test_variants_script_replaces_text_of_the_source():
    """Every replacement of scripts/torch_int8_attention_f32_variants.py
    finds its text in the kernel's source (or tf32x3.cuh), so each variant
    differs from the design where its name says."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "torch_int8_attention_f32_variants.py")
    spec = importlib.util.spec_from_file_location("k13_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    base = module.sources_of("this")
    for name in module.VARIANTS:
        texts = module.sources_of(name)
        assert (texts != base) == (name != "this"), name
