"""The f32 forwards K1-K4 and K6 and backwards K5-K9 (csrc/*_f32.cu,
csrc/ffma.cuh, csrc/tf32x3_wgmma.cuh) as far as the CPU reaches them:
their plans at the
flagship, at 130 rows, at every width of ``models/vit3d.py`` WIDTHS and
the smoke model's, and at head dims 32, 64 and 128; the kernels' index
maps (the f32 attention backward's cp.async staging copies) modelled in
numpy; their dropout bytes against ``nn.keep_mask``; and the dispatch rule (CPU tensors run the
plain versions, f32 CUDA tensors the f32 kernels, bf16 ones the bf16
kernels), forward and backward, in both attention layouts; what the
attention wrappers hand their entry points, with the launch stubbed. The
kernels themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py's ``f32`` phase).
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import common
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv, tf32x3
from neurovit_tpu_torch.ops.common import SMEM_LIMIT

torch.set_num_threads(1)

F32_COUNTED = (fa.flash_attention_f32_cuda, fused_qkv.fused_ln_qkv_f32_cuda,
               fused_outproj.fused_outproj_residual_f32_cuda,
               fused_mlp.fused_mlp_block_f32_cuda,
               fa.flash_attention_bwd_f32_cuda,
               fused_qkv.fused_ln_qkv_bwd_f32_cuda,
               fused_outproj.fused_outproj_bwd_f32_cuda,
               fused_mlp.fused_mlp_bwd_f32_cuda,
               fa.flash_attention_bhnd_f32_cuda,
               fa.flash_attention_bhnd_bwd_f32_cuda)
# Rows: one volume, 130, the flagship at batch 8 and 32 (1001 tokens).
ROWS = [1001, 130, 8008, 32032]
# The verify recipe's smoke model: dim 64, 4 heads of 16, MLP 128.
SMOKE = (64, 4, 16, 128)
BWD_WIDTHS = sorted(WIDTHS.values()) + [SMOKE]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_f32_gemm_plans(width, m):
    """K2, K3 and K4 at f32: each splits its weights first (the plain
    pre-pass, a launch a weight), K2 and K4 then run LayerNorm rows a warp
    each, then GEMMs in 3xTF32 on wgmma whose 128 x 128 tiles cover the
    output (K3's one GEMM is K4's fc2_residual with K = inner); the
    scratch holds u (and g) f32 on 256-byte boundaries."""
    dim, heads, dh, hid = WIDTHS[width]
    inner = heads * dh
    for return_u in (False, True):
        plan = fused_qkv.qkv_f32_plan(m, dim, inner, return_u=return_u)
        split, (ln, grid, threads, smem), gemm = plan.launches
        assert split == tf32x3.split_launch("split_wqkv", 3 * inner * dim)
        assert (ln, grid, threads, smem) == ("ln_rows", (-(-m // 8), 1), 256,
                                             0)
        assert gemm[0] == "qkv_gemm" and plan.tile_n == 128
        _tf32x3_gemm_covers(gemm, m, 3 * inner)
        assert plan.scratch == ({} if return_u else {"u": (0, m * dim * 4)})
        assert plan.scratch_bytes % 256 == 0
        assert plan.scratch_bytes >= sum(b for _, b in plan.scratch.values())
    plan = fused_outproj.outproj_f32_plan(m, dim, inner)
    split, gemm = plan.launches
    assert split == tf32x3.split_launch("split_wout", dim * inner)
    assert gemm[0] == "fc2_residual" and plan.tile_n == 128
    _tf32x3_gemm_covers(gemm, m, dim)
    plan = fused_mlp.mlp_f32_plan(m, dim, hid)
    split1, split2, ln, fc1, fc2 = plan.launches
    assert split1 == tf32x3.split_launch("split_w1", hid * dim)
    assert split2 == tf32x3.split_launch("split_w2", dim * hid)
    assert ln[:3] == ("ln_rows", (-(-m // 8), 1), 256)
    assert (fc1[0], fc2[0]) == ("fc1_gelu", "fc2_residual")
    _tf32x3_gemm_covers(fc1, m, hid)
    _tf32x3_gemm_covers(fc2, m, dim)
    (u0, ub), (g0, gb) = plan.scratch["u"], plan.scratch["g"]
    assert (u0, ub, gb) == (0, m * dim * 4, m * hid * 4)
    assert g0 % 256 == 0 and g0 >= ub
    assert plan.scratch_bytes % 256 == 0 and plan.scratch_bytes >= g0 + gb


def _tf32x3_gemm_covers(launch, m, n):
    """A 3xTF32 GEMM on wgmma (csrc/tf32x3_wgmma.cuh: K8 f32's dattn, K4
    f32's fc1 and fc2, K3 f32's fc2 launch, K2 f32's QKV): two consumer
    warpgroups and the producer warp, four 48 KiB stages, one block an SM,
    128 x 128 tiles over the [m, n] output."""
    name, grid, threads, smem = launch
    assert threads == fused_mlp.GEMM_THREADS == 288
    assert smem == tf32x3.SMEM == 1024 + 4 * 3 * 16384 + 64
    assert smem <= SMEM_LIMIT < 2 * smem
    assert grid[0] * 128 >= n > (grid[0] - 1) * 128
    assert grid[1] * 128 >= m > (grid[1] - 1) * 128


def _ln_bwd_f32_covers(launches, scratch, nbytes, m, dim):
    """The f32 du GEMM in 3xTF32 on wgmma, LayerNorm rows and column sums
    of tf32x3_ln_bwd.cuh, and their scratch: du, the statistics, the row
    sums over one part a 128-column tile, the column sums over one part a
    128-row tile, each on a 256-byte boundary."""
    du, rows, cols = launches
    assert du[0] == "du"
    _tf32x3_gemm_covers(du, m, dim)
    assert rows == ("ln_bwd", (-(-m // 8), 1), 256, 0)
    assert cols == ("colsum", (2 * dim // 32, 1), 256, 0)
    col_parts, row_parts = -(-dim // 128), -(-m // 128)
    sizes = {"du": m * dim * 4, "stats": m * 8,
             "rowpart": 2 * m * col_parts * 4,
             "colpart": 2 * row_parts * dim * 4}
    at = 0
    for name, (offset, size) in scratch.items():
        assert (offset, size) == (at, sizes[name])
        at = -(-(offset + size) // 256) * 256
    assert list(scratch) == list(sizes) and nbytes == at


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("dim,heads,dh,hid", BWD_WIDTHS)
def test_f32_bwd_gemm_plans(dim, heads, dh, hid, m):
    """K7, K8 and K9 at f32: each weight's transposing pre-pass first, row
    passes a warp a row, 3xTF32 GEMMs on wgmma whose 128 x 128 tiles cover
    the output (K8's dattn over [m, inner], K9's hidden over [m, hid], the
    du GEMM over [m, dim]), and the LayerNorm backward's scratch."""
    inner = heads * dh
    plan = fused_qkv.qkv_bwd_f32_plan(m, dim, inner)
    wsplit, stats = plan.launches[:2]
    assert wsplit == tf32x3.split_t_launch(3 * inner, dim, "wsplit_wqkv")
    assert stats == ("row_stats", (-(-m // 8), 1), 256, 0)
    _ln_bwd_f32_covers(plan.launches[2:], plan.scratch, plan.scratch_bytes,
                       m, dim)
    for rate in (0.0, 0.1):
        plan = fused_outproj.outproj_bwd_f32_plan(m, dim, inner, rate)
        wsplit, *rows, gemm = plan.launches
        assert wsplit == tf32x3.split_t_launch(dim, inner)
        assert rows == ([("dz_rows", (-(-m // 8), 1), 256, 0)] if rate
                        else [])
        assert gemm[0] == "dattn" and plan.tile_n == 128
        _tf32x3_gemm_covers(gemm, m, inner)
    plan = fused_mlp.mlp_bwd_f32_plan(m, dim, hid)
    split2, split1, rows, hidden = plan.launches[:4]
    assert split2 == tf32x3.split_t_launch(dim, hid, "wsplit_w2")
    assert split1 == tf32x3.split_t_launch(hid, dim, "wsplit_w1")
    assert rows == ("dz_rows", (-(-m // 8), 1), 256, 0)
    assert hidden[0] == "hidden"
    _tf32x3_gemm_covers(hidden, m, hid)
    _ln_bwd_f32_covers(plan.launches[4:], plan.scratch, plan.scratch_bytes,
                       m, dim)


@pytest.mark.parametrize("b,n", [(1, 1), (1, 130), (8, 1001), (32, 1001)])
@pytest.mark.parametrize("d,d_kernel", [(8, 32), (16, 32), (32, 32),
                                        (64, 64), (80, 128), (128, 128)])
def test_flash_f32_bwd_plan(d, d_kernel, b, n):
    """K5 at f32: K1 f32's instances, 64 rows a block of 128 threads (four
    warps of 16 rows) in both passes, 32 keys (pass 1) or queries (pass 2)
    a tile through two stages, pass 2's blocks splitting D = 128 into two
    64-column halves, staged rows D + 4 floats apart (4 mod
    32: tf32x3.cuh's conflict-free fragment loads, 16-byte aligned for
    cp.async); shared memory under 227 KB, and at D = 64 small enough for
    three blocks an SM. It is K6's backward's at f32 too (the layout moves
    only where a head's rows lie;
    test_bhnd_f32_wrappers_launch_as_bnhd_f32)."""
    plan = fa.flash_f32_bwd_plan(b, n, 8, d)
    assert plan.d_kernel == d_kernel == fa.f32_head_dim(d)
    assert (plan.rows, plan.tile, plan.threads) == (64, 32, 128)
    assert plan.rows == 16 * plan.threads // 32
    assert plan.cols == min(d_kernel, 64)
    assert plan.ld == d_kernel + 4 and plan.ld % 32 == 4
    assert plan.ld * 4 % 16 == 0
    tiles = -(-n // 64)
    assert plan.dq_grid == (tiles * b * 8,)
    assert plan.dkv_grid == (tiles * (d_kernel // plan.cols) * b * 8,)
    assert plan.dq_smem == (2 * 64 + 4 * 32) * (d_kernel + 4) * 4
    assert plan.dkv_smem == ((2 * 64 + 4 * 32) * (d_kernel + 4)
                             + 4 * 32) * 4
    assert max(plan.dq_smem, plan.dkv_smem) <= SMEM_LIMIT
    if d_kernel <= 64:
        assert 3 * max(plan.dq_smem, plan.dkv_smem) <= SMEM_LIMIT


def test_f32_bwd_plans_refuse_what_bf16_refuses():
    """The f32 backwards take the widths and head dims the bf16 ones
    take, and refuse the same others."""
    for plan in (lambda: fa.flash_f32_bwd_plan(1, 10, 2, 160),
                 lambda: fa.flash_bwd_plan(1, 10, 2, 160, "bnhd")):
        with pytest.raises(ValueError, match="head dim <= 128"):
            plan()
    for plan in (lambda: fa.flash_f32_bwd_plan(2 ** 16, 2 ** 12, 2 ** 4, 64),
                 lambda: fa.flash_bwd_plan(2 ** 16, 2 ** 12, 2 ** 4, 64,
                                           "bnhd")):
        with pytest.raises(ValueError, match="2\\^31"):
            plan()
    for f32, bf16 in (
            (lambda: fused_qkv.qkv_bwd_f32_plan(10, 72, 64),
             lambda: fused_qkv.qkv_bwd_plan(10, 72, 64)),
            (lambda: fused_outproj.outproj_bwd_f32_plan(10, 64, 40, 0.1),
             lambda: fused_outproj.outproj_bwd_plan(10, 64, 40, 0.1)),
            (lambda: fused_mlp.mlp_bwd_f32_plan(10, 64, 100),
             lambda: fused_mlp.mlp_bwd_plan(10, 64, 100))):
        for plan in (f32, bf16):
            with pytest.raises(ValueError, match="multiple of 16"):
                plan()
    for plan in (lambda: fused_qkv.qkv_bwd_f32_plan(0, 64, 64),
                 lambda: fused_outproj.outproj_bwd_f32_plan(0, 64, 64, 0.0),
                 lambda: fused_mlp.mlp_bwd_f32_plan(0, 64, 64)):
        with pytest.raises(ValueError, match="at least one row"):
            plan()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_outproj_bwd_f32_plan_launch_order_and_grids(rate):
    """K8 f32: the weight pre-pass first (the wrapper launches it before
    the C entry point), then at dropout > 0 dz_rows, then dattn; at the
    flagship (batch 1, 8, 32 x 1001 rows: 4 x 8, 4 x 63, 4 x 251 tiles,
    the pre-pass 16 x 32 tiles of Wout [1024, 512]), at ragged rows, at
    the 2D tutorial's 64 / 64 and at inner 1040 (9 column tiles, the last
    holding 16 columns)."""
    names = ["wsplit", "dz_rows", "dattn"] if rate else ["wsplit", "dattn"]
    for m, dim, inner, wsplit, dattn in (
            (1001, 1024, 512, (16, 32), (4, 8)),
            (8008, 1024, 512, (16, 32), (4, 63)),
            (32032, 1024, 512, (16, 32), (4, 251)),
            (1, 1024, 512, (16, 32), (4, 1)),
            (8009, 1024, 512, (16, 32), (4, 63)),
            (197, 64, 64, (2, 2), (1, 2)),
            (8008, 1024, 1040, (33, 32), (9, 63)),
            (130, 48, 80, (3, 2), (1, 2))):
        plan = fused_outproj.outproj_bwd_f32_plan(m, dim, inner, rate)
        assert [launch[0] for launch in plan.launches] == names
        assert plan.launches[0] == ("wsplit", wsplit, 256, 0)
        assert plan.launches[-1][1] == dattn
        _tf32x3_gemm_covers(plan.launches[-1], m, inner)
        if rate:
            assert plan.launches[1] == ("dz_rows", (-(-m // 8), 1), 256, 0)


@pytest.mark.parametrize("dim,inner,match", [
    (1000, 512, "dim as a multiple of 16"),
    (1024, 1288, "inner as a multiple of 16"),
    (1024, 8, "inner as a multiple of 16"),
    (8, 64, "dim as a multiple of 16")])
def test_outproj_bwd_f32_plan_refuses_widths_off_16(dim, inner, match):
    """K8 f32 refuses the widths bf16 K8 refuses, by the same gate."""
    for rate in (0.0, 0.1):
        for plan in (fused_outproj.outproj_bwd_f32_plan,
                     fused_outproj.outproj_bwd_plan):
            with pytest.raises(ValueError, match=match) as err:
                plan(130, dim, inner, rate)
            assert "ROADMAP.md, Queue 3" in str(err.value)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_outproj_bwd_f32_wrapper_hands_its_entry_points(monkeypatch, rate):
    """What K8 f32's wrapper hands ``launch`` on dy [2, 9, 64] and Wout
    [64, 32] (operand checks and launches replaced by a record): the
    pre-pass on Wout (rows 64, cols 32) into big and small [32, 64], then
    ``nvt_fused_outproj_f32_bwd`` with those two, dattn and dz (null at
    dropout 0), M 18, inner 32, dim 64, the dropout's arguments and the
    seed; each wrapper counts its own launch. The counters are
    restored after the test."""
    seen = []

    def record(symbol, argtypes, like, *args):
        seen.append((symbol, argtypes, args))

    for module in (fused_outproj, tf32x3):
        monkeypatch.setattr(module, "check_operand", lambda *a, **k: None)
        monkeypatch.setattr(module, "launch", record)
    counted = (tf32x3.split_t_cuda, fused_outproj.fused_outproj_bwd_f32_cuda)
    before = [fn.launches for fn in counted]
    try:
        dy, w = torch.zeros(2, 9, 64), torch.zeros(64, 32)
        dattn, dz = fused_outproj.fused_outproj_bwd_f32_cuda(
            dy, w, dropout_rate=rate, seed=5)
        assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1]
    finally:
        for fn, b in zip(counted, before):
            fn.launches = b
    (split_sym, split_types, split_args), (sym, types, args) = seen
    assert split_sym == "nvt_wsplit_f32"
    assert len(split_types) == 5 and split_args[3:] == (64, 32)
    assert sym == "nvt_fused_outproj_f32_bwd" and len(types) == 11
    assert [a.value for a in args[1:3]] == [a.value for a in split_args[1:3]]
    assert args[3].value == dattn.data_ptr() and dattn.shape == (2, 9, 32)
    inv_keep, keep_q = common.dropout_args(rate)
    assert args[5:] == (18, 32, 64, inv_keep, keep_q, 5)
    if rate:
        assert args[4].value == dz.data_ptr() and dz is not dy
    else:
        assert args[4].value is None and dz is dy


@pytest.mark.parametrize("b,n", [(1, 1), (1, 130), (8, 1001), (32, 1001),
                                 (280, 1001)])
@pytest.mark.parametrize("d,d_kernel", [(8, 32), (16, 32), (32, 32),
                                        (64, 64), (80, 128), (128, 128)])
def test_flash_f32_plan(d, d_kernel, b, n):
    """K1 at f32: instances at 32, 64 and 128 (other head dims padded), a
    64-row query tile a block of 128 threads, 32 keys a stage of a ring of
    three (two at head dim 128); shared memory (the 1 KiB alignment slack,
    the Q box, the ring's K and V boxes, their full and empty barriers and
    Q's) under 227 KB. It is K6's at f32 too
    (test_bhnd_f32_wrappers_launch_as_bnhd_f32)."""
    plan = fa.flash_f32_plan(b, n, 8, d)
    assert plan.d_kernel == d_kernel == fa.f32_head_dim(d)
    stages = 2 if d_kernel == 128 else 3
    assert (plan.bq, plan.bkv, plan.stages, plan.threads) == (
        64, 32, stages, 128)
    assert plan.grid == (-(-n // 64) * b * 8,)
    assert plan.smem == 1024 + (64 + 2 * stages * 32) * d_kernel * 4 + (
        2 * stages + 1) * 8
    assert plan.smem <= SMEM_LIMIT


def test_f32_plans_refuse_what_bf16_refuses():
    """The f32 instances take the widths and head dims the bf16 ones take,
    and refuse the same others."""
    with pytest.raises(ValueError, match="head dim <= 128"):
        fa.flash_f32_plan(1, 10, 2, 160)
    with pytest.raises(ValueError, match="2\\^31"):
        fa.flash_f32_plan(2 ** 16, 2 ** 12, 2 ** 4, 64)
    for plan in (lambda: fused_qkv.qkv_f32_plan(10, 72, 64),
                 lambda: fused_outproj.outproj_f32_plan(10, 64, 40),
                 lambda: fused_mlp.mlp_f32_plan(10, 64, 100)):
        with pytest.raises(ValueError, match="multiple of 16"):
            plan()
    for plan in (lambda: fused_qkv.qkv_f32_plan(0, 64, 64),
                 lambda: fused_outproj.outproj_f32_plan(0, 64, 64),
                 lambda: fused_mlp.mlp_f32_plan(0, 64, 64)):
        with pytest.raises(ValueError, match="at least one row"):
            plan()


def test_gemm_staging_copies_are_a_conflict_free_bijection():
    """The cp.async staging of the f32 attention backward's products
    (flash_attention_bwd_f32.cu ``stage``, on ffma.cuh's cp_async16; the
    f32 GEMMs of the block load by TMA): a block of 128 threads copies
    rows r0 .. r0 + kN of a head, D / 4 16-byte chunks a row, copy c =
    threadIdx.x + 128 i to row c / (D / 4), chunk c % (D / 4), at float r
    (D + 4) + 4 ch of the tile. At the kernel's head dims (32, 64, 128)
    and tile heights (64-row K / V tiles, 32-row Q / dO stages): every
    chunk once, 16-byte aligned; each quarter-warp's eight 16-byte stores
    fall in eight distinct four-bank groups and read 128 contiguous bytes
    of one row; rows past N (ragged) are the zero-filled copies."""
    threads = 128
    for d in (32, 64, 128):
        chunks, ld = d // 4, d + 4
        assert ld * 4 % 16 == 0
        for rows, n_left in ((64, 64), (64, 37), (32, 32), (32, 5)):
            c = np.arange(rows * chunks)
            r, ch = c // chunks, c % chunks
            at = r * ld + 4 * ch
            assert len(set(at.tolist())) == c.size
            assert (at % 4 == 0).all() and (4 * ch + 4 <= d).all()
            thread, it = c % threads, c // threads
            np.testing.assert_array_equal(thread + threads * it, c)
            for start in range(0, c.size, 8):
                quarter = slice(start, start + 8)
                groups = (at[quarter] % 32) // 4
                assert len(set(groups.tolist())) == 8
                assert len(set(r[quarter].tolist())) == 1
                assert (np.diff(ch[quarter]) == 1).all()
            valid = r < n_left
            assert valid.sum() == min(rows, n_left) * chunks


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_gemm_dropout_bytes_are_keep_mask(rate):
    """ffma.cuh keep4 at every float4 of an [m, n] site (n % 16 == 0):
    word (i >> 2) & 3 of Philox(i >> 4), its four bytes below q, equal to
    nn.keep_mask's bits. The dz rows pass of K8 and K9 at f32 (at row *
    dim + col) draws it so; the 3xTF32 epilogues of K2, K3, K4 and K9's
    hidden GEMM draw keep_quad (tests/test_torch_mlp_qkv_fwd_tf32x3.py,
    tests/test_torch_outproj_fwd_tf32x3.py,
    tests/test_torch_mlp_qkv_bwd_tf32x3.py)."""
    m, n, seed = 5, 48, 0x1234_5678_9ABC
    q, _ = nn.keep_threshold(rate)
    want = nn.keep_mask(seed, (m, n), rate).reshape(-1).numpy()
    got = np.zeros(m * n, bool)
    for i in range(0, m * n, 4):
        w = nn.philox4x32(torch.tensor([i >> 4]), seed)[0].tolist()
        word = w[(i >> 2) & 3]
        for j in range(4):
            got[i + j] = ((word >> (8 * j)) & 0xFF) < q
    np.testing.assert_array_equal(got, want)


def _block_args(rng, dtype=torch.float32):
    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dtype)
    return t


def test_cpu_f32_runs_the_plain_versions_and_counts_nothing():
    """f32 CPU tensors through the four public ops, serving and in
    training (autograd functions, forward and backward), equal the plain
    versions; no f32 (or bf16) kernel counts a launch."""
    before = [fn.launches for fn in F32_COUNTED]
    t = _block_args(np.random.default_rng(3))
    x, g, bt = t(2, 9, 64), t(64), t(64)
    w = t(3 * 64, 64, scale=0.1)
    for grad in (False, True):
        params = [p.clone().requires_grad_(grad) for p in (g, bt, w)]
        got = fused_qkv.fused_ln_qkv(x, *params, 4, 16)
        want = fused_qkv.fused_ln_qkv_plain(x, g, bt, w, 4, 16)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        q, k, v = got
        o = fa.flash_attention(q, k, v, scale=0.25, n_valid=7)
        torch.testing.assert_close(
            o, fa.flash_attention_plain(q, k, v, scale=0.25, n_valid=7),
            rtol=0, atol=0)
        wo, bo = t(64, 64, scale=0.1), t(64)
        y = fused_outproj.fused_outproj_residual(x, o.reshape(2, 9, 64), wo,
                                                 bo)
        torch.testing.assert_close(y, fused_outproj.fused_outproj_residual_plain(
            x, o.reshape(2, 9, 64), wo, bo), rtol=0, atol=0)
        args = (y, g, bt, t(128, 64, scale=0.1), t(128), t(64, 128, scale=0.1),
                t(64))
        out = fused_mlp.fused_mlp_block(*args)
        torch.testing.assert_close(out, fused_mlp.fused_mlp_block_plain(
            *args), rtol=0, atol=0)
        if grad:
            out.sum().backward()
            assert all(p.grad is not None for p in params)
    assert [fn.launches for fn in F32_COUNTED] == before == [0] * 10


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "f32"), (torch.bfloat16, "bf16"),
    (torch.float16, "bf16")])
def test_dispatch_on_card_tensors(monkeypatch, dtype, kernel):
    """With operands taken as on the card: f32 picks each op's f32
    kernel, forward and backward, bf16 its bf16 kernel, and any other
    dtype the bf16 kernel, which raises for it (there is no fallback);
    in the bhnd layout the same with K6's kernels."""
    for module in (common, fa):
        monkeypatch.setattr(module, "on_cpu", lambda *_: False)
    x = torch.zeros(1, 4, 64, dtype=dtype)
    q = torch.zeros(1, 4, 2, fa.MIN_KERNEL_HEAD_DIM, dtype=dtype)
    picks = {
        "qkv": fused_qkv._forward(x),
        "outproj": fused_outproj._forward(x),
        "mlp": fused_mlp._forward(x),
        "attention": fa._impl("bnhd", False, q),
        "attention_bwd": fa._impl("bnhd", True, q),
    }
    for name, module, op in (("qkv_bwd", fused_qkv, "fused_ln_qkv_bwd"),
                             ("outproj_bwd", fused_outproj,
                              "fused_outproj_bwd"),
                             ("mlp_bwd", fused_mlp, "fused_mlp_bwd")):
        picks[name] = common.pick(getattr(module, op + "_plain"),
                                  getattr(module, op + "_cuda"),
                                  getattr(module, op + "_f32_cuda"), x)
    want = {
        "f32": {"qkv": fused_qkv.fused_ln_qkv_f32_cuda,
                "outproj": fused_outproj.fused_outproj_residual_f32_cuda,
                "mlp": fused_mlp.fused_mlp_block_f32_cuda,
                "attention": fa.flash_attention_f32_cuda,
                "attention_bwd": fa.flash_attention_bwd_f32_cuda,
                "qkv_bwd": fused_qkv.fused_ln_qkv_bwd_f32_cuda,
                "outproj_bwd": fused_outproj.fused_outproj_bwd_f32_cuda,
                "mlp_bwd": fused_mlp.fused_mlp_bwd_f32_cuda},
        "bf16": {"qkv": fused_qkv.fused_ln_qkv_cuda,
                 "outproj": fused_outproj.fused_outproj_residual_cuda,
                 "mlp": fused_mlp.fused_mlp_block_cuda,
                 "attention": fa.flash_attention_cuda,
                 "attention_bwd": fa.flash_attention_bwd_cuda,
                 "qkv_bwd": fused_qkv.fused_ln_qkv_bwd_cuda,
                 "outproj_bwd": fused_outproj.fused_outproj_bwd_cuda,
                 "mlp_bwd": fused_mlp.fused_mlp_bwd_cuda}}[kernel]
    assert picks == want
    bhnd = {"f32": (fa.flash_attention_bhnd_f32_cuda,
                    fa.flash_attention_bhnd_bwd_f32_cuda),
            "bf16": (fa.flash_attention_bhnd_cuda,
                     fa.flash_attention_bhnd_bwd_cuda)}[kernel]
    assert (fa._impl("bhnd", False, q), fa._impl("bhnd", True, q)) == bhnd


def test_f32_wrappers_refuse_cpu_tensors():
    """Each f32 kernel's wrapper takes CUDA tensors only: on CPU tensors it
    raises before any launch, and counts nothing."""
    before = [fn.launches for fn in F32_COUNTED]
    t = _block_args(np.random.default_rng(4))
    x = t(1, 5, 64)
    calls = [
        lambda: fa.flash_attention_f32_cuda(t(1, 5, 2, 32), t(1, 5, 2, 32),
                                            t(1, 5, 2, 32), scale=0.2),
        lambda: fused_qkv.fused_ln_qkv_f32_cuda(x, t(64), t(64), t(96, 64),
                                                2, 16),
        lambda: fused_outproj.fused_outproj_residual_f32_cuda(
            x, t(1, 5, 32), t(64, 32), t(64)),
        lambda: fused_mlp.fused_mlp_block_f32_cuda(
            x, t(64), t(64), t(128, 64), t(128), t(64, 128), t(64)),
        lambda: fa.flash_attention_bwd_f32_cuda(
            *(t(1, 5, 2, 32) for _ in range(5)), t(1, 2, 5), scale=0.2,
            n_valid=5),
        lambda: fused_qkv.fused_ln_qkv_bwd_f32_cuda(t(1, 5, 96), x, t(64),
                                                    t(96, 64)),
        lambda: fused_outproj.fused_outproj_bwd_f32_cuda(x, t(64, 32)),
        lambda: fused_mlp.fused_mlp_bwd_f32_cuda(
            x, x, t(1, 5, 128), t(64), t(64), t(128, 64), t(64, 128)),
        lambda: fa.flash_attention_bhnd_f32_cuda(
            t(1, 2, 5, 32), t(1, 2, 5, 32), t(1, 2, 5, 32), scale=0.2),
        lambda: fa.flash_attention_bhnd_bwd_f32_cuda(
            *(t(1, 2, 5, 32) for _ in range(5)), t(1, 2, 5), scale=0.2,
            n_valid=5),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert [fn.launches for fn in F32_COUNTED] == before


# ---------------------------------------------------------------------------
# What the attention wrappers hand their entry points (launch stubbed)
# ---------------------------------------------------------------------------

ATTENTION_COUNTED = (fa.flash_attention_cuda, fa.flash_attention_f32_cuda,
                     fa.flash_attention_bhnd_cuda,
                     fa.flash_attention_bhnd_f32_cuda,
                     fa.flash_attention_bwd_cuda,
                     fa.flash_attention_bwd_f32_cuda,
                     fa.flash_attention_bhnd_bwd_cuda,
                     fa.flash_attention_bhnd_bwd_f32_cuda)


def _attention_launch(monkeypatch, wrapper, layout, backward):
    """(symbol, argtypes, the arguments that are not pointers) that an
    attention wrapper hands ``launch`` on q, k, v (and o, dO, the row sums)
    of batch 2, 9 tokens, 3 heads of 16 in ``layout``, with the operand
    checks and the launch replaced by a record."""
    seen = []
    monkeypatch.setattr(fa, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(fa, "launch", lambda symbol, argtypes, like, *args:
                        seen.append((symbol, argtypes, args)))
    b, n, h, d = 2, 9, 3, 16
    shape = (b, n, h, d) if layout == "bnhd" else (b, h, n, d)
    kw = dict(scale=0.25, n_valid=7, dropout_rate=0.1, seed=3)
    if backward:
        wrapper(*(torch.zeros(shape) for _ in range(5)),
                torch.zeros(b, h, n), **kw)
    else:
        wrapper(*(torch.zeros(shape) for _ in range(3)), return_stats=True,
                **kw)
    (symbol, argtypes, args), = seen
    return symbol, argtypes, [a for a in args if not hasattr(a, "value")]


@pytest.mark.parametrize("backward", [False, True])
def test_bhnd_f32_wrappers_launch_as_bnhd_f32(monkeypatch, backward):
    """K6 f32's wrappers call ``nvt_flash_attention_bhnd_f32_{fwd,bwd}``
    with the argument types and scalars the bnhd f32 wrappers pass (b, n,
    h, the head-dim instance of the plan both layouts share, n_valid, the
    scales and the dropout's), and each launch counts on its own wrapper
    alone. The counters are restored after the test."""
    for fn in ATTENTION_COUNTED:
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = [fn.launches for fn in ATTENTION_COUNTED]
    suffix = "bwd" if backward else "fwd"
    bnhd = _attention_launch(monkeypatch,
                             getattr(fa, f"flash_attention{'_bwd' * backward}"
                                         "_f32_cuda"), "bnhd", backward)
    bhnd = _attention_launch(monkeypatch,
                             getattr(fa, "flash_attention_bhnd"
                                         f"{'_bwd' * backward}_f32_cuda"),
                             "bhnd", backward)
    assert bnhd[0] == f"nvt_flash_attention_f32_{suffix}"
    assert bhnd[0] == f"nvt_flash_attention_bhnd_f32_{suffix}"
    assert bhnd[1:] == bnhd[1:]
    plan = (fa.flash_f32_bwd_plan if backward else fa.flash_f32_plan)(
        2, 9, 3, 16)
    assert bhnd[2][:5] == [2, 9, 3, plan.d_kernel, 7]
    grew = [fn.launches - b for fn, b in zip(ATTENTION_COUNTED, before)]
    assert grew == ([0, 0, 0, 0, 0, 1, 0, 1] if backward
                    else [0, 1, 0, 1, 0, 0, 0, 0])
