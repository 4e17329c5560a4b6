"""K14's and K15's walk (``ops/maxpool3d.py`` ``pool_plan``) on the CPU.

The plan at the ResNet stem's shape [B, 90, 45, 45, 64] at batch 1, 8 and
64 and at ``tests/test_torch_maxpool.py``'s shapes, bf16 and f32: its
shared memory within a block's limit and equal to its own count, every
work item inside the tensor, every output (K14) and every dx element (K15)
owned by exactly one item; the ordinary-load path where rows are not
16-byte runs (C = 3); no grid limit at B * D > 65535; tiles that split the
columns or the channels where whole rows do not fit.

The emulated walk plays each block of the persistent grid as the kernels
do: its items in order, each item's depth planes staged into a ring of
``slots`` slots (only the rows, columns and channels the item stages),
the next items' planes as soon as a step frees slots, each plane read only
from its slot and only while it is there. K14's step combines depth in
place over plane 2od, frees plane 2od - 1's slot for the next plane and
runs the 9 taps; K15's gathers dx of depths 2od and 2od + 1 from planes
od and od + 1. Bits: equal to the plain versions
(values compared NaN for NaN; dx bit for bit, the same f32 terms in the
same order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurovit_tpu_torch.ops import maxpool3d as mp
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

STEM = (90, 45, 45, 64)
SHAPES = [(2, 9, 7, 10, 8), (1, 8, 8, 8, 4), (2, 5, 6, 9, 16),
          (3, 10, 5, 5, 8)]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
PLAN_SHAPES = [(b, *STEM) for b in (1, 8, 64)] + SHAPES
# Beside the plan shapes: ragged rows (C = 3), B * D past 65535, a row too
# wide for a whole-row tile, channels too many for one tile.
ODD_SHAPES = [(2, 9, 7, 45, 3), (730, 90, 1, 1, 8), (1, 6, 4, 900, 64),
              (1, 4, 4, 4, 4096)]


def _boxes(kind, shape, p):
    return [mp.pool_item(kind, shape, p, i) for i in range(p.items)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", PLAN_SHAPES + ODD_SHAPES)
def test_plan_fits_and_items_lie_inside(shape, dtype):
    plan = mp.pool_plan(shape, DTYPES[dtype])
    b, d, h, w, c = shape
    od, oh, ow = (mp.out_dim(n) for n in (d, h, w))
    elt = DTYPES[dtype].itemsize
    for kind, p in zip(("fwd", "bwd"), plan):
        assert p.smem_bytes <= SMEM_LIMIT
        assert p.smem_bytes == mp.pool_smem_bytes(kind, shape, elt, p.rows,
                                                  p.cols, p.chans, p.slots)
        assert p.slots == mp.SLOTS[kind]
        assert 1 <= p.grid <= min(p.items, mp.SMS * mp.MAX_BLOCKS_PER_SM[kind])
        assert 1 <= p.rows <= oh and 1 <= p.cols <= ow
        assert 1 <= p.chans <= c and 1 <= p.chunks <= od
        assert p.vec == (8 if c % 8 == 0 and p.chans % 8 == 0 else 1)
        for t in _boxes(kind, shape, p):
            assert 0 <= t.b < b
            assert 0 <= t.od[0] < t.od[1] <= od
            assert 0 <= t.chans[0] < t.chans[1] <= c
            assert 0 <= t.in_rows[0] < t.in_rows[1] <= h
            assert 0 <= t.in_cols[0] < t.in_cols[1] <= w
            assert 0 <= t.out_rows[0] < t.out_rows[1] <= oh
            assert 0 <= t.out_cols[0] < t.out_cols[1] <= ow
            lim = d if kind == "fwd" else od
            assert 0 <= t.planes[0] < t.planes[1] <= lim
            assert t.chans[1] - t.chans[0] <= p.chans
            if kind == "fwd":    # the staged rows are those the taps read
                assert t.in_rows == (max(0, 2 * t.out_rows[0] - 1),
                                     min(h, 2 * t.out_rows[1]))
                assert t.out_rows[1] - t.out_rows[0] <= p.rows
            else:     # the staged windows cover the dx rows and columns
                for (lo, hi), (o_lo, o_hi), n in (
                        (t.in_rows, t.out_rows, oh),
                        (t.in_cols, t.out_cols, ow)):
                    assert lo % 2 == 0 and o_lo == lo // 2
                    assert min(n - 1, hi // 2) == o_hi - 1
                assert t.in_rows[1] - t.in_rows[0] <= 2 * p.rows


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_stem_plan(batch, dtype):
    """At the stem's shape every tile is whole rows of all 64 channels,
    staged by bulk copies, 8 channels a thread; the bands are 3 output rows
    but for the f32 forward's 1 (five slots of 5 or 7 rows of 45 x 64 f32
    would not fit); the grid fills the card's SMs once the items do, and
    from batch 8 there are items for nearly every SM."""
    plan = mp.pool_plan((batch, *STEM), DTYPES[dtype])
    for kind, p in zip(("fwd", "bwd"), plan):
        assert (p.cols, p.chans, p.bulk, p.vec) == (23, 64, True, 8)
        assert p.rows == (1 if kind == "fwd" and dtype == "f32" else 3)
        assert p.grid == min(p.items, mp.SMS * min(
            mp.MAX_BLOCKS_PER_SM[kind], mp.SM_SMEM // (p.smem_bytes + 1024)))
        assert p.items >= 0.95 * mp.SMS or batch == 1


@pytest.mark.parametrize("shape", PLAN_SHAPES + ODD_SHAPES)
def test_every_output_and_dx_element_has_one_owner(shape):
    b, d, h, w, c = shape
    od, oh, ow = (mp.out_dim(n) for n in (d, h, w))
    plan = mp.pool_plan(shape, torch.bfloat16)
    # Batch items past 4 are counted apart: as many items each as item 0.
    nb = min(b, 4)
    fwd = np.zeros((nb, od, oh, ow, c), np.uint8)
    bwd = np.zeros((nb, d, h, w, c), np.uint8)
    per_b = {"fwd": np.zeros(b, int), "bwd": np.zeros(b, int)}
    for t in _boxes("fwd", shape, plan.fwd):
        per_b["fwd"][t.b] += 1
        if t.b < nb:
            fwd[t.b, slice(*t.od), slice(*t.out_rows), slice(*t.out_cols),
                slice(*t.chans)] += 1
    for t in _boxes("bwd", shape, plan.bwd):
        per_b["bwd"][t.b] += 1
        if t.b < nb:
            d_run = slice(2 * t.od[0], min(d, 2 * t.od[1]))
            bwd[t.b, d_run, slice(*t.in_rows), slice(*t.in_cols),
                slice(*t.chans)] += 1
    assert fwd.min() == fwd.max() == 1
    assert bwd.min() == bwd.max() == 1
    for kind, p in zip(("fwd", "bwd"), plan):
        assert (per_b[kind] == p.items // b).all() and p.items % b == 0


def test_ragged_rows_take_ordinary_loads():
    """C = 3: 45 * 3 * 2 bytes of a bf16 row is no multiple of 16, so
    neither kernel stages by bulk copies; a bf16 row of 8 x 4 channels (64
    bytes) is, though 4 channels (8 bytes) are not."""
    for dtype in DTYPES.values():
        plan = mp.pool_plan((2, 9, 7, 45, 3), dtype)
        assert not plan.fwd.bulk and not plan.bwd.bulk
        assert plan.fwd.vec == plan.bwd.vec == 1
    plan = mp.pool_plan((1, 8, 8, 8, 4), torch.bfloat16)
    assert plan.fwd.bulk and plan.fwd.cols == 4    # whole rows of x
    assert plan.bwd.bulk          # 4 x 4 codes and 4 x 4 x 2 bytes of g


def test_no_grid_limit():
    """B * D = 65700 > 65535 and H = 70000: planned, no refusal."""
    for shape in ((730, 90, 1, 1, 8), (1, 3, 70000, 3, 8)):
        for dtype in DTYPES.values():
            plan = mp.pool_plan(shape, dtype)
            for p in plan:
                assert p.grid <= mp.SMS * 4 and p.items >= p.grid


def test_tiles_split_columns_and_channels_only_where_rows_do_not_fit():
    plan = mp.pool_plan((1, 6, 4, 900, 64), torch.float32)
    assert plan.fwd.cols < mp.out_dim(900) and plan.fwd.chans == 64
    assert plan.fwd.bulk                 # runs of 64 f32 channels
    plan = mp.pool_plan((1, 4, 4, 4, 4096), torch.float32)
    assert plan.fwd.chans < 4096 and plan.fwd.chans % 8 == 0
    assert plan.fwd.bulk and plan.fwd.vec == 8
    with pytest.raises(ValueError):
        mp.pool_plan((1, 0, 4, 4, 4), torch.float32)
    with pytest.raises(TypeError):
        mp.pool_plan((1, 4, 4, 4, 4), torch.float16)


# --------------------------------------------------------------------------
# The emulated walk
# --------------------------------------------------------------------------

class _Ring:
    """One block's ring: its items' planes, item after item, plane s of
    the stream in slot s % slots; ``stage`` fills free slots as the
    kernels' ``Ring::stage`` does."""

    def __init__(self, kind, shape, p, block, fetch):
        self.kind, self.shape, self.p, self.fetch = kind, shape, p, fetch
        self.slots = [None] * p.slots
        self.loaded = self.released = 0
        self.item, self.plane = block, 0

    def stage(self):
        p = self.p
        while self.loaded < self.released + p.slots and self.item < p.items:
            t = mp.pool_item(self.kind, self.shape, p, self.item)
            d = t.planes[0] + self.plane
            self.slots[self.loaded % p.slots] = (self.loaded, self.fetch(t, d))
            self.loaded += 1
            self.plane += 1
            if self.plane == t.planes[1] - t.planes[0]:
                self.plane, self.item = 0, self.item + p.grid

    def read(self, s):
        tag, data = self.slots[s % self.p.slots]
        assert tag == s and s >= self.released
        return data


def _neg_inf_pad(tile, rows, cols, lo_r, lo_c, fill):
    """``tile`` (staged rows x cols x channels) placed into a frame of
    ``rows`` x ``cols`` at (lo_r, lo_c), ``fill`` elsewhere."""
    out = torch.full((rows, cols, tile.shape[-1]), fill, dtype=tile.dtype)
    out[lo_r:lo_r + tile.shape[0], lo_c:lo_c + tile.shape[1]] = tile
    return out


def emulate_fwd(x: torch.Tensor, p) -> tuple:
    b, d, h, w, c = x.shape
    od_n, oh_n, ow_n = (mp.out_dim(n) for n in (d, h, w))
    out = torch.full((b, od_n, oh_n, ow_n, c), float("nan"), dtype=x.dtype)
    codes = torch.full(out.shape, 255, dtype=torch.uint8)
    shape = tuple(x.shape)

    def fetch(t, dd):
        return x[t.b, dd, slice(*t.in_rows), slice(*t.in_cols),
                 slice(*t.chans)].clone()

    for block in range(p.grid):
        ring = _Ring("fwd", shape, p, block, fetch)
        ring.stage()
        base = 0
        for i in range(block, p.items, p.grid):
            t = mp.pool_item("fwd", shape, p, i)
            for od in range(*t.od):
                s1 = base + 2 * od - t.planes[0]
                v = ring.read(s1 - 1).float() if od > 0 else None
                row = ring.read(s1).float()
                if v is None:
                    v = torch.full_like(row, float("-inf"))
                kd = (row > v).to(torch.int32)
                v = torch.maximum(v, row)
                if 2 * od + 1 < d:
                    row = ring.read(s1 + 1).float()
                    kd = torch.where(row > v, 2, kd)
                    v = torch.maximum(v, row)
                # In place over plane 2od, in x's dtype; plane 2od - 1's
                # slot refills before the taps.
                ring.read(s1).copy_(v.to(x.dtype))
                if od > 0:
                    ring.released = base + 2 * od - 1 - t.planes[0]
                    ring.stage()
                comb = ring.read(s1).float()
                r0, r1 = t.out_rows
                q0, q1 = t.out_cols
                rows, cols = 2 * (r1 - r0) + 1, 2 * (q1 - q0) + 1
                lo_r, lo_c = t.in_rows[0] - (2 * r0 - 1), \
                    t.in_cols[0] - (2 * q0 - 1)
                vp = _neg_inf_pad(comb, rows, cols, lo_r, lo_c, float("-inf"))
                cp = _neg_inf_pad(kd, rows, cols, lo_r, lo_c, 0)
                best = code = None
                for kh in range(3):
                    for kw in range(3):
                        tap = vp[kh:rows - 2 + kh:2, kw:cols - 2 + kw:2]
                        tc = cp[kh:rows - 2 + kh:2, kw:cols - 2 + kw:2] * 9 + (
                            3 * kh + kw)
                        if best is None:
                            best, code = tap, tc
                        else:
                            code = torch.where(tap > best, tc, code)
                            best = torch.maximum(best, tap)
                out[t.b, od, r0:r1, q0:q1, slice(*t.chans)] = best.to(x.dtype)
                codes[t.b, od, r0:r1, q0:q1, slice(*t.chans)] = code.to(
                    torch.uint8)
                ring.released = base + (t.planes[1] - t.planes[0]
                                        if od + 1 == t.od[1]
                                        else 2 * od - t.planes[0] + 1)
                ring.stage()
            base += t.planes[1] - t.planes[0]
    return out, codes


def emulate_bwd(codes: torch.Tensor, g: torch.Tensor, x_shape, p):
    b, d, h, w, c = x_shape
    od_n, oh_n, ow_n = codes.shape[1:4]
    dx = torch.full(tuple(x_shape), float("nan"), dtype=g.dtype)

    def fetch(t, o):
        box = (t.b, o, slice(*t.out_rows), slice(*t.out_cols),
               slice(*t.chans))
        return g[box].float().clone(), codes[box].to(torch.int32).clone()

    for block in range(p.grid):
        ring = _Ring("bwd", tuple(x_shape), p, block, fetch)
        ring.stage()
        base = 0
        for i in range(block, p.items, p.grid):
            t = mp.pool_item("bwd", tuple(x_shape), p, i)
            s0, s1 = t.out_rows
            q0, q1 = t.out_cols
            for od in range(*t.od):
                s = base + od - t.planes[0]
                lo = ring.read(s)
                hi = ring.read(s + 1) if od + 1 < od_n else None
                for dd, depth in ((0, [(lo, 1)]),
                                  (1, ([(hi, 0)] if hi else []) + [(lo, 2)])):
                    if 2 * od + dd >= d:
                        continue
                    # dx over input rows 2 s0 - 1 .. 2 s1 - 1 (and columns),
                    # each window's g added where its code names the tap,
                    # in increasing code order.
                    acc = torch.zeros(2 * (s1 - s0) + 1, 2 * (q1 - q0) + 1,
                                      t.chans[1] - t.chans[0])
                    for (gp, cd), kd in depth:
                        for kh in range(3):
                            for kw in range(3):
                                k = 9 * kd + 3 * kh + kw
                                acc[kh:kh + 2 * (s1 - s0):2,
                                    kw:kw + 2 * (q1 - q0):2] += torch.where(
                                        cd == k, gp, torch.zeros(()))
                    r_lo = t.in_rows[0] - (2 * s0 - 1)
                    c_lo = t.in_cols[0] - (2 * q0 - 1)
                    dx[t.b, 2 * od + dd, slice(*t.in_rows),
                       slice(*t.in_cols), slice(*t.chans)] = acc[
                        r_lo:r_lo + t.in_rows[1] - t.in_rows[0],
                        c_lo:c_lo + t.in_cols[1] - t.in_cols[0]].to(g.dtype)
                ring.released = base + (t.planes[1] - t.planes[0]
                                        if od + 1 == t.od[1]
                                        else od - t.planes[0] + 1)
                ring.stage()
            base += t.planes[1] - t.planes[0]
    return dx


def _input(kind, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    if kind == "tie_heavy":
        a = np.maximum(rng.integers(-3, 4, shape), 0).astype(np.float32)
    elif kind == "nan_inf":
        pick = rng.random(shape)
        a[pick < 0.03] = np.nan
        a[(pick >= 0.03) & (pick < 0.06)] = np.inf
        a[(pick >= 0.06) & (pick < 0.12)] = -np.inf
    return a


def _same(got, want):
    """Equal values, NaN where the other is NaN, and equal dtypes."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.float()[~nan], want.float()[~nan])


EMULATED = [(s, sms) for s in SHAPES for sms in (mp.SMS, 2)] + [
    ((2, 9, 7, 45, 3), 2), ((1, 4, 4, 4, 4096), 2), ((1, 5, 4, 300, 64), 3)]


@pytest.mark.parametrize("kind", ["continuous", "tie_heavy", "nan_inf"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,sms", EMULATED)
def test_emulated_walk_gives_plain_bits(shape, sms, dtype, kind):
    """sms 2 or 3 puts several items on a block, so the ring runs from one
    item's planes into the next's."""
    dt = DTYPES[dtype]
    x = torch.from_numpy(_input(kind, shape, sum(shape))).to(dt)
    plan = mp.pool_plan(shape, dt, sms)
    out, codes = emulate_fwd(x, plan.fwd)
    want, want_codes = mp.max_pool3d_argmax_plain(x)
    _same(out, want)
    assert torch.equal(codes, want_codes)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(dt)
    dx = emulate_bwd(codes, g, shape, plan.bwd)
    assert torch.equal(dx, mp.max_pool3d_argmax_bwd_plain(codes, g, shape, dt))


def test_emulated_walk_at_the_stem_batch_1():
    """The stem's plan as the card runs it (132 SMs), bf16, continuous."""
    shape = (1, *STEM)
    x = torch.from_numpy(_input("continuous", shape, 5)).to(torch.bfloat16)
    plan = mp.pool_plan(shape, torch.bfloat16)
    out, codes = emulate_fwd(x, plan.fwd)
    want, want_codes = mp.max_pool3d_argmax_plain(x)
    assert torch.equal(out, want) and torch.equal(codes, want_codes)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(torch.bfloat16)
    dx = emulate_bwd(codes, g, shape, plan.bwd)
    assert torch.equal(dx, mp.max_pool3d_argmax_bwd_plain(
        codes, g, shape, torch.bfloat16))
    # F.max_pool3d's values, a check of the plain version itself.
    ref = F.max_pool3d(x.float().permute(0, 4, 1, 2, 3), 3, 2, 1)
    assert torch.equal(out.float(), ref.permute(0, 2, 3, 4, 1))


def test_device_times_script_refuses_without_card_and_counts_the_bound():
    """scripts/torch_pool_device_times.py measures on the card only, and
    its bound counts x (dx) and out (g) at 2 bytes and the codes at 1."""
    import importlib.util
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_pool_device_times",
        os.path.join(here, "scripts", "torch_pool_device_times.py"))
    times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(times)
    if not torch.cuda.is_available():
        assert times.main([]) == 1
    x = torch.zeros(8, *STEM, dtype=torch.bfloat16, device="meta")
    out = torch.zeros(8, 45, 23, 23, 64, dtype=torch.bfloat16, device="meta")
    codes = torch.zeros(out.shape, dtype=torch.uint8, device="meta")
    bound = times.bound_ms({"x": x, "g": out, "codes": codes})
    assert bound == pytest.approx((2 * x.numel() + 3 * out.numel())
                                  / 3.35e12 * 1e3)
    assert 0.0666 < bound < 0.0667
