"""The Hopper kernels against their plain PyTorch versions on the card, at
small and ragged shapes (the model's shapes are in chip_smoke.py): the
forward kernels K1-K4 with and without dropout, the backward kernels K5,
K7, K8 and K9, K6 (the [B, H, N, D] attention, forward and backward) and
the Grad-CAM probe that runs it, the int8 serving kernels K10-K13, the
ResNet stem's max-pool K14 and its backward K15 (continuous, tie-heavy
and NaN / +-inf inputs, C = 3 on the ordinary-load path, B * D past 65535,
the stem at batch 1, walks of many items a block and of tiled columns and
channels, the plan's shared memory); K1-K13 at every ViT width
of the matrix (``models/vit3d.py`` WIDTHS: head dims 16, 32, 64, 80 and
128, the ViT-S/B/L widths), head dim < 8 on the plain attention; the probes' kernels, K16
(fused dropout, bit-equal forward and backward) and K17/K18 (the GEMM
probes: int8 and K18 bit-equal, bf16 within K 2^-23 sum|a||b|); and the
attention forward K1/K6 and backward K5/K6's on TMA + wgmma at head dims
16-128, n_valid on and next to the 64-key tile edges, grids under and over
the 132 SMs, with descriptor probes (V one-hot by key, dO one-hot by query),
repeat calls bit for bit, their shared-memory plans, and B * H past 65535;
and K4, K9 and K12 on TMA + wgmma at ragged rows (1-300, 8008), ViT-H,
dim 1536 / mlp 6144 and mlp 8192, ragged column tiles, all-zero rows,
repeat calls bit for bit (K4 also without h, K9 on K4's own h and with
dgamma / dbeta) and their plans' scratch and shared-memory bytes against
the kernels' counts; K2 on TMA + wgmma at ragged rows (1-2002, 8008),
dims 64-2048 and inners 256-2048 (ViT-H and dim 2048 among them), with
and without u, u served from the scratch bit-equal to u returned,
all-zero rows, repeat calls bit for bit and its plan's bytes against the
kernel's counts; K7 on TMA + wgmma at ragged rows (1-300, 8008), dims
64-1536 and inners 80-1280 (ViT-H and 1536 / 1536 among them), an
all-zero dqkv and all-zero rows of it, repeat calls bit for bit and its
plan's bytes against the kernel's counts; and K13 on TMA + wgmma at head dims 16-128, n_valid
on and off the key tiles, batch 8 and 32 at 1001 tokens, repeat calls bit
for bit, its prologue's scales and permuted codes bit for bit, an all-zero
V, B * H past 65535 and its plan's bytes against the kernel's counts; and
K3 and K11 on TMA + wgmma (K4's and K12's fc2_residual pass) at ragged
rows (1-8008), the flagship at batch 1 (64-column tiles) and 8, and the
widths their wmma versions refused (K11's inner 1280-2048, K3's inner
2048), K3 at dropout 0 and 0.1 with the dropped positions those of the
plain mask, K11 bit-equal to plain, all-zero rows of a, repeat calls bit
for bit and their plans' bytes against the kernels' counts; and K8 on
K9's dz rows pass and a TMA + wgmma GEMM at 1-8008 rows, every width of
the matrix, ViT-H, dim 1536 and 2048 and inner 1040 (not a multiple of
64), at dropout 0 (dz is dy) and 0.1 (dz bit-equal to plain), repeat
calls bit for bit and its plan's shared memory against the kernel's; and
K1-K4 at f32 (FFMA on the CUDA cores) at rtol = atol = 1e-4: K1 at head
dims 16-128, n_valid off the key tiles and the flagship at batch 8, K2
with and without u, K3, K4 with h, at dropout 0 and 0.1, all-zero rows,
repeat calls bit for bit, the plans' bytes against the kernels', and an
f32 ViT's forward launching only the f32 kernels; and the f32 backwards
K5, K7, K8 and K9 at the same tolerance for the data gradients (dgamma
and dbeta by relative Frobenius error <= 1e-5: f32 sums over the rows
taken in another order), K5 at head dims 16-128 and n_valid off the key
tiles, K8 and K9 at dropout 0 and 0.1 (dz is dy at 0), K8 (3xTF32 on
wgmma after its weight pre-pass) also at the 2D tutorial's 64 / 64 and
ViT-S/B/L widths, dattn within 1e-5 relative Frobenius error of plain,
the pre-pass bit-equal to its plain version, all-zero rows,
repeat calls bit for bit, the plans' bytes against the kernels', and an
f32 ViT's train step launching only the f32 kernels, its gradients
against the CPU plain path's; and K10-K13 at f32 (the int8 serving of an
f32 ViT): K10 and K12 with the codes in their scratch one step off
plain's at most and their outputs plain's arithmetic on those codes bit
for bit, K11 bit-equal to plain, K13 at head dims 16-128 and n_valid off
the key tiles with its prologue's codes and scales bit for bit, all-zero
rows, repeat calls bit for bit, K13 f32's plan against the kernel, an f32
ViT quantized to int8 launching only the f32 int8 kernels, and no spill
in any f32 instance of csrc/int8_*.cu.

These need an NVIDIA GPU with sm_90a and nvcc; elsewhere they skip. Run on
the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance, elementwise: |kernel - plain| <= 1e-2 + 2^-6 |plain| for the
forwards. The two sides round to bf16 at the same points; an f32 sum taken
in another order can land on the other side of a rounding boundary, one
bf16 ulp. The dropout masks are the same bits on both sides. Backward data
gradients: |kernel - plain| <= 1e-4 + 2e-2 max|plain| + 2^-6 |plain| (an
ulp of a bf16 intermediate -- ds, dz, dh -- moves a sum of many terms; the
1e-4 floor covers gradients that cancel to 0, such as dq over one key);
dgamma and dbeta: relative Frobenius error <= 1e-2. The int8 kernels take
the forwards' tolerance: their int32 products are exact on both sides, and
an f32 LayerNorm, GELU or sum taken in another order may move one int8
code by one step, which moves an output by far less than 1e-2. K14's
values and codes equal the plain version's bit for bit (both compare in
f32 and pick the same winner), and so does K15's dx (both add the same
f32 terms in increasing code order and round once).
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import WIDTHS
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                    int8_serving, maxpool3d)

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-2, 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, device, dtype=torch.bfloat16, scale=1.0, offset=0.0):
    a = offset + scale * rng.standard_normal(shape)
    return torch.tensor(a, dtype=dtype, device=device)


def _check(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert ((g - w).abs() <= ATOL + RTOL * w.abs()).all(), \
            float((g - w).abs().max())


@pytest.mark.parametrize("b,n,n_valid", [(1, 1, 1), (2, 70, 70),
                                         (2, 130, 97), (1, 1001, 1001)])
def test_flash_attention_kernel(cuda, b, n, n_valid):
    rng = np.random.default_rng(n)
    q, k, v = (_rand(rng, (b, n, 3, 64), cuda) for _ in range(3))
    args = (q, k, v)
    kw = {"scale": 0.125, "n_valid": n_valid}
    before = fa.flash_attention_cuda.launches
    _check(fa.flash_attention(*args, **kw), fa.flash_attention_plain(*args, **kw))
    assert fa.flash_attention_cuda.launches == before + 1


@pytest.mark.parametrize("m", [1, 65, 300])
def test_fused_ln_qkv_kernel(cuda, m):
    rng = np.random.default_rng(m)
    x = _rand(rng, (1, m, 512), cuda)
    gamma = _rand(rng, (512,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (512,), cuda, torch.float32, 0.1)
    w = _rand(rng, (3 * 256, 512), cuda, torch.float32, 512 ** -0.5)
    args = (x, gamma, beta, w, 4, 64)
    _check(fused_qkv.fused_ln_qkv(*args), fused_qkv.fused_ln_qkv_plain(*args))


@pytest.mark.parametrize("m", [1, 65, 300])
def test_fused_outproj_kernel(cuda, m):
    rng = np.random.default_rng(m)
    x = _rand(rng, (1, m, 512), cuda)
    a = _rand(rng, (1, m, 128), cuda)
    w = _rand(rng, (512, 128), cuda, torch.float32, 128 ** -0.5)
    b = _rand(rng, (512,), cuda, torch.float32, 0.05)
    args = (x, a, w, b)
    _check(fused_outproj.fused_outproj_residual(*args),
           fused_outproj.fused_outproj_residual_plain(*args))


@pytest.mark.parametrize("m", [1, 33, 300])
def test_fused_mlp_kernel(cuda, m):
    rng = np.random.default_rng(m)
    x = _rand(rng, (1, m, 256), cuda)
    gamma = _rand(rng, (256,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (256,), cuda, torch.float32, 0.1)
    w1 = _rand(rng, (384, 256), cuda, torch.float32, 256 ** -0.5)
    b1 = _rand(rng, (384,), cuda, torch.float32, 0.05)
    w2 = _rand(rng, (256, 384), cuda, torch.float32, 384 ** -0.5)
    b2 = _rand(rng, (256,), cuda, torch.float32, 0.05)
    args = (x, gamma, beta, w1, b1, w2, b2)
    _check(fused_mlp.fused_mlp_block(*args),
           fused_mlp.fused_mlp_block_plain(*args))


def _check_grads(got, want, params=()):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), i
        if i in params:
            err = float((g - w).norm() / w.norm().clamp_min(1e-12))
            assert err <= 1e-2, (i, err)
        else:
            tol = 1e-4 + 2e-2 * float(w.abs().max()) + RTOL * w.abs()
            assert ((g - w).abs() <= tol).all(), (i, float((g - w).abs().max()))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid", [(1, 1, 1), (2, 70, 70),
                                         (2, 130, 97)])
def test_flash_attention_fwd_bwd_kernels(cuda, b, n, n_valid, rate):
    rng = np.random.default_rng(n + 1)
    q, k, v, do = (_rand(rng, (b, n, 3, 64), cuda) for _ in range(4))
    kw = {"scale": 0.125, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 77}
    o, lsum = fa.flash_attention_cuda(q, k, v, return_stats=True, **kw)
    o_p, lsum_p = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
    _check((o,), (o_p,))
    assert torch.allclose(lsum, lsum_p, rtol=1e-5)
    before = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, o_p, do, lsum_p, **kw)
    assert fa.flash_attention_bwd_cuda.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o_p, do, lsum_p, **kw)
    _check_grads(got, want)
    assert not got[1][:, n_valid:].any() and not got[2][:, n_valid:].any()



@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid", [(1, 1, 1), (2, 70, 61),
                                         (2, 130, 97), (1, 1001, 900)])
def test_flash_attention_bhnd_kernels(cuda, b, n, n_valid, rate):
    """K6 forward and backward against their plain versions, and bit for
    bit K1 and K5 on the transposed inputs: one arithmetic in two layouts,
    the same dropout bits."""
    rng = np.random.default_rng(n + 8)
    q, k, v, do = (_rand(rng, (b, 3, n, 64), cuda) for _ in range(4))
    kw = {"scale": 0.125, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 78}
    before = (fa.flash_attention_bhnd_cuda.launches,
              fa.flash_attention_bhnd_bwd_cuda.launches)
    o, lsum = fa.flash_attention_bhnd_cuda(q, k, v, return_stats=True, **kw)
    o_p, lsum_p = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True,
                                                **kw)
    _check((o,), (o_p,))
    assert torch.allclose(lsum, lsum_p, rtol=1e-5)
    got = fa.flash_attention_bhnd_bwd_cuda(q, k, v, o_p, do, lsum_p, **kw)
    _check_grads(got, fa.flash_attention_bhnd_bwd_plain(q, k, v, o_p, do,
                                                        lsum_p, **kw))
    assert not got[1][:, :, n_valid:].any() and not got[2][:, :, n_valid:].any()
    assert (fa.flash_attention_bhnd_cuda.launches,
            fa.flash_attention_bhnd_bwd_cuda.launches) == (before[0] + 1,
                                                           before[1] + 1)

    def tr(t):
        return t.transpose(1, 2).contiguous()

    o1, lsum1 = fa.flash_attention_cuda(tr(q), tr(k), tr(v),
                                        return_stats=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, tr(o1)) and torch.equal(lsum, lsum1)
    got1 = fa.flash_attention_bwd_cuda(tr(q), tr(k), tr(v), tr(o_p), tr(do),
                                       lsum_p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, tr(g1)) for g, g1 in zip(got, got1))


def test_gradcam_probe_runs_k6(cuda):
    """One Grad-CAM probe of a small bf16 model on the card launches the
    fused forward kernels on the first block, K4 on both, K6 forward and
    backward and K9 once, and no other backward kernel; its activations and
    gradients agree with the same weights on the CPU plain path within a
    relative Frobenius error of 2e-2."""
    from neurovit_tpu.config import load_config
    from neurovit_tpu_torch.explainability import gradcam_vit3d as gc
    from neurovit_tpu_torch.models import NeuroEncoder

    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 10, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "bf16",
        "TRAINING_DROPOUT": 0.1, "MODEL_VIT_DIM": 512, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": 2, "MODEL_VIT_DIM_HEAD": 64,
        "MODEL_VIT_MLP_DIM": 384})
    gpu = NeuroEncoder(config, device=cuda, seed=5)
    cpu = NeuroEncoder(config, device="cpu", seed=5)
    counted = {"k1": fa.flash_attention_cuda, "k2": fused_qkv.fused_ln_qkv_cuda,
               "k3": fused_outproj.fused_outproj_residual_cuda,
               "k4": fused_mlp.fused_mlp_block_cuda,
               "k5": fa.flash_attention_bwd_cuda,
               "k6": fa.flash_attention_bhnd_cuda,
               "k6_bwd": fa.flash_attention_bhnd_bwd_cuda,
               "k7": fused_qkv.fused_ln_qkv_bwd_cuda,
               "k8": fused_outproj.fused_outproj_bwd_cuda,
               "k9": fused_mlp.fused_mlp_bwd_cuda}
    before = {name: fn.launches for name, fn in counted.items()}
    x = torch.randn(3, 10, 10, 10, generator=torch.Generator().manual_seed(6))
    _, _, acts, grads = gc.probe_acts_grads(gpu, x.to(cuda))
    torch.cuda.synchronize()
    launched = {name: fn.launches - before[name]
                for name, fn in counted.items()}
    assert launched == {"k1": 1, "k2": 1, "k3": 1, "k4": 2, "k5": 0, "k6": 1,
                        "k6_bwd": 1, "k7": 0, "k8": 0, "k9": 1}
    _, _, acts_p, grads_p = gc.probe_acts_grads(cpu, x)
    for got, want in ((acts, acts_p), (grads, grads_p)):
        got = got.float().cpu()
        assert torch.isfinite(got).all()
        err = float((got - want).norm() / want.norm())
        assert err <= 2e-2, err

@pytest.mark.parametrize("m", [1, 33, 65, 300])
def test_fused_ln_qkv_kernel_with_u(cuda, m):
    rng = np.random.default_rng(m + 1)
    x = _rand(rng, (1, m, 256), cuda)
    gamma = _rand(rng, (256,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (256,), cuda, torch.float32, 0.1)
    w = _rand(rng, (3 * 128, 256), cuda, torch.bfloat16, 256 ** -0.5)
    *qkv, u = fused_qkv.fused_ln_qkv_cuda(x, gamma, beta, w, 2, 64,
                                          return_u=True)
    *qkv_p, u_p = fused_qkv.fused_ln_qkv_plain(x, gamma, beta, w, 2, 64,
                                               return_u=True)
    _check(tuple(qkv) + (u,), tuple(qkv_p) + (u_p,))


# K2 on TMA + wgmma: (m, dim, heads, dim_head). Ragged rows (1, 65, 130,
# 300, 2002), the flagship at batch 8 (8008 = 62 tiles + 72 rows), inner
# 320 off both tile widths (the last tile of q and k reads Wqkv's rows of
# the next section), ViT-H (1280, 16 x 80) and the widths the wmma K2
# refused (its [64, dim] u block in shared memory): dim 1536 past one
# 64-column box, and dim 2048 at inner 1024 and 2048; grids on both sides
# of the 64-column tile rule.
QKV_CASES = [(1, 1024, 8, 64), (65, 1024, 8, 64), (300, 1024, 8, 64),
             (8008, 1024, 8, 64), (300, 64, 4, 80), (65, 384, 6, 64),
             (130, 1280, 16, 80), (8008, 1280, 16, 80), (1, 1536, 24, 64),
             (2002, 1536, 24, 64), (300, 2048, 16, 64),
             (130, 2048, 16, 128)]


def _qkv_args(rng, m, dim, heads, dh, device, zero_rows=(),
              zero_beta=False):
    """K2's operands for x [1, m, dim]; ``zero_rows`` of x are 0, and with
    ``zero_beta`` beta is 0 too, so u is 0 on those rows."""
    x = _rand(rng, (1, m, dim), device)
    x[0, list(zero_rows)] = 0
    gamma = _rand(rng, (dim,), device, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (dim,), device, torch.float32, 0.1)
    if zero_beta:
        beta.zero_()
    w = _rand(rng, (3 * heads * dh, dim), device, torch.bfloat16,
              dim ** -0.5)
    return (x, gamma, beta, w, heads, dh)


@pytest.mark.parametrize("return_u", [False, True])
@pytest.mark.parametrize("m,dim,heads,dh", QKV_CASES)
def test_fused_ln_qkv_kernel_widths(cuda, m, dim, heads, dh, return_u):
    """K2 against plain, with and without u, one launch-count a call."""
    args = _qkv_args(np.random.default_rng(m + dim + heads * dh), m, dim,
                     heads, dh, cuda)
    before = fused_qkv.fused_ln_qkv_cuda.launches
    _check(fused_qkv.fused_ln_qkv_cuda(*args, return_u=return_u),
           fused_qkv.fused_ln_qkv_plain(*args, return_u=return_u))
    assert fused_qkv.fused_ln_qkv_cuda.launches == before + 1


def _served_u(args):
    """q, k, v and u of one serving launch of K2, u read back from the
    scratch the serving call allocates (the wrapper's launch, by hand)."""
    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.ops import common
    x, gamma, beta, w, heads, dh = args
    b, n, dim = x.shape
    plan = fused_qkv.qkv_plan(b * n, dim, heads * dh)
    q, k, v = (x.new_empty(b, n, heads, dh) for _ in range(3))
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    p = common.ptr
    common.launch("nvt_fused_ln_qkv_fwd", (common.VOID,) * 8
                  + (common.INT,) * 3 + (common.FLOAT,), x, p(x), p(gamma),
                  p(beta), p(w), p(q), p(k), p(v), p(scratch), b * n, dim,
                  heads * dh, nn.LN_EPS)
    u = scratch[:b * n * dim * 2].view(torch.bfloat16).reshape(x.shape)
    return q, k, v, u


@pytest.mark.parametrize("m,dim,heads,dh", [(130, 256, 4, 80),
                                            (8008, 1024, 8, 64),
                                            (300, 2048, 16, 128)])
def test_fused_ln_qkv_kernel_repeats_and_u(cuda, m, dim, heads, dh):
    """Two training calls bit-equal (u included); u within the bf16
    tolerance of the plain version's and bit-equal to the u a serving
    call leaves in its scratch, and the serving call's q, k, v equal."""
    args = _qkv_args(np.random.default_rng(m + 17), m, dim, heads, dh, cuda)
    one, two = (fused_qkv.fused_ln_qkv_cuda(*args, return_u=True)
                for _ in range(2))
    served = _served_u(args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert all(torch.equal(a, b) for a, b in zip(one, served))
    _check(one[3], fused_qkv.fused_ln_qkv_plain(*args, return_u=True)[3])


@pytest.mark.parametrize("zero_beta", [True, False])
def test_fused_ln_qkv_kernel_zero_rows(cuda, zero_beta):
    """All-zero rows of x at a tile's first and last row and in the ragged
    tile: with beta = 0, u is 0 there, so q = k = v = 0 exactly; the rest
    matches plain."""
    rows = (0, 127, 128, 129)
    args = _qkv_args(np.random.default_rng(5), 130, 256, 4, 64, cuda,
                     zero_rows=rows, zero_beta=zero_beta)
    got = fused_qkv.fused_ln_qkv_cuda(*args, return_u=True)
    _check(got, fused_qkv.fused_ln_qkv_plain(*args, return_u=True))
    if zero_beta:
        assert all(not t[0, list(rows)].float().abs().max() for t in got)


def test_qkv_plan_matches_the_kernel(cuda):
    """The wrapper's K2 plan (``qkv_plan``) counts the serving scratch and
    the GEMM pass's shared memory (which follows its tile width) as the
    kernel does, at every width of the matrix and the card tests' widths,
    on both sides of the 64-column tile rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch = lib.nvt_fused_ln_qkv_fwd_scratch_bytes
    smem = lib.nvt_fused_ln_qkv_fwd_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[1] * w[2]) for w in WIDTHS.values()] + [
        (d, h * dh) for _, d, h, dh in QKV_CASES]
    for dim, inner in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032, 128128):
            plan = fused_qkv.qkv_plan(m, dim, inner)
            assert scratch(m, dim, inner) == plan.scratch_bytes, (m, dim,
                                                                  inner)
            assert [s for *_, s in plan.launches] == [
                0, smem(m, inner)], (m, dim, inner)


# K7's widths: the smoke model's dim with inner 128, inner 80 (3 inner =
# 240, a K tail inside one 64-column box), ViT-S-like 256 / 320, the
# flagship's 1024 / 512, and ViT-H's 1280 / 1280 and 1536 / 1536, which the
# wmma K7 refused (dim > 1024).
QKV_BWD_WIDTHS = [(64, 128), (256, 80), (256, 320), (1024, 512),
                  (1280, 1280), (1536, 1536)]


def _qkv_bwd_args(rng, m, dim, inner, device):
    x = _rand(rng, (1, m, dim), device)
    gamma = _rand(rng, (dim,), device, torch.float32, 0.1, 1.0)
    w = _rand(rng, (3 * inner, dim), device, torch.bfloat16, dim ** -0.5)
    dqkv = _rand(rng, (1, m, 3 * inner), device, scale=0.1)
    return dqkv, x, gamma, w


@pytest.mark.parametrize("dim,inner", QKV_BWD_WIDTHS)
@pytest.mark.parametrize("m", [1, 33, 65, 300, 8008])
def test_fused_ln_qkv_bwd_kernel(cuda, m, dim, inner):
    args = _qkv_bwd_args(np.random.default_rng(m + dim + inner), m, dim,
                         inner, cuda)
    before = fused_qkv.fused_ln_qkv_bwd_cuda.launches
    _check_grads(fused_qkv.fused_ln_qkv_bwd_cuda(*args),
                 fused_qkv.fused_ln_qkv_bwd_plain(*args), params=(1, 2))
    assert fused_qkv.fused_ln_qkv_bwd_cuda.launches == before + 1


@pytest.mark.parametrize("m,dim,inner", [(130, 256, 320), (8008, 1024, 512),
                                         (300, 1280, 1280)])
def test_fused_ln_qkv_bwd_kernel_repeats(cuda, m, dim, inner):
    """K7 twice on the same operands: dx, dgamma and dbeta bit-equal (sums
    in a fixed order, no atomics)."""
    args = _qkv_bwd_args(np.random.default_rng(m + 13), m, dim, inner, cuda)
    one, two = (fused_qkv.fused_ln_qkv_bwd_cuda(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(one, two))


@pytest.mark.parametrize("zero", ["all", "rows"])
def test_fused_ln_qkv_bwd_kernel_zero(cuda, zero):
    """An all-zero dqkv gives du = 0, so dx = 0 and dgamma = dbeta = 0
    exactly; all-zero rows of dqkv at a tile's first and last row and in
    the ragged tile give dx = 0 on those rows, and the rest matches
    plain."""
    rows = [0, 127, 128, 129]
    dqkv, x, gamma, w = _qkv_bwd_args(np.random.default_rng(7), 130, 256,
                                      320, cuda)
    if zero == "all":
        dqkv.zero_()
    else:
        dqkv[0, rows] = 0
    got = fused_qkv.fused_ln_qkv_bwd_cuda(dqkv, x, gamma, w)
    _check_grads(got, fused_qkv.fused_ln_qkv_bwd_plain(dqkv, x, gamma, w),
                 params=() if zero == "all" else (1, 2))
    dx = got[0].reshape(130, -1)
    if zero == "all":
        assert not any(float(t.float().abs().max()) for t in got)
    else:
        assert not dx[rows].float().abs().max()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [1, 33, 65, 300])
def test_fused_outproj_fwd_bwd_kernels(cuda, m, rate):
    rng = np.random.default_rng(m + 2)
    x = _rand(rng, (1, m, 512), cuda)
    a = _rand(rng, (1, m, 128), cuda)
    w = _rand(rng, (512, 128), cuda, torch.bfloat16, 128 ** -0.5)
    b = _rand(rng, (512,), cuda, torch.float32, 0.05)
    kw = {"dropout_rate": rate, "seed": 5}
    _check(fused_outproj.fused_outproj_residual_cuda(x, a, w, b, **kw),
           fused_outproj.fused_outproj_residual_plain(x, a, w, b, **kw))
    dy = _rand(rng, (1, m, 512), cuda)
    got = fused_outproj.fused_outproj_bwd_cuda(dy, w, **kw)
    want = fused_outproj.fused_outproj_bwd_plain(dy, w, **kw)
    assert torch.equal(got[1], want[1])          # dz: the same mask bits
    _check_grads(got, want)


def _mlp_args(rng, m, dim, hid, device, zero_rows=(), zero_bias=False):
    """K4's operands for x [1, m, dim]; ``zero_rows`` of x are 0, and with
    ``zero_bias`` beta and b1 are 0 too, so u, h and g of those rows are 0
    and y there is bf16(b2 * mask2 / keep)."""
    x = _rand(rng, (1, m, dim), device)
    x[0, list(zero_rows)] = 0
    gamma = _rand(rng, (dim,), device, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (dim,), device, torch.float32, 0.1)
    w1 = _rand(rng, (hid, dim), device, torch.bfloat16, dim ** -0.5)
    b1 = _rand(rng, (hid,), device, torch.float32, 0.05)
    w2 = _rand(rng, (dim, hid), device, torch.bfloat16, hid ** -0.5)
    b2 = _rand(rng, (dim,), device, torch.float32, 0.05)
    if zero_bias:
        beta.zero_()
        b1.zero_()
    return (x, gamma, beta, w1, b1, w2, b2)


# K4 and K9 on TMA + wgmma: one row, ragged last row tiles (33, 65, 130,
# 300), the flagship's rows at batch 8 (8008 = 62 tiles + 72); the smoke
# model's and a ragged width (hid 384: three column tiles, 384 = 3 x 128;
# dim 256), ViT-H (1280 / 5120), dim 1536 / mlp 6144 and mlp 8192 at dim
# 1024, widths the wmma kernels refused (K4 the last two of them, K9 the
# dims past 1024). K9 runs on K4's own h.
MLP_WIDTHS = [(64, 128), (256, 384), (1280, 5120), (1536, 6144),
              (1024, 8192)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dim,hid", MLP_WIDTHS)
@pytest.mark.parametrize("m", [1, 33, 65, 130, 300, 8008])
def test_fused_mlp_fwd_bwd_kernels(cuda, m, dim, hid, rate):
    args = _mlp_args(np.random.default_rng(m + 3 + dim + hid), m, dim, hid,
                     cuda)
    kw = {"dropout_rate": rate, "seeds": (8, 9)}
    got = fused_mlp.fused_mlp_block_cuda(*args, return_h=True, **kw)
    _check(got, fused_mlp.fused_mlp_block_plain(*args, return_h=True, **kw))
    x, gamma, beta, w1, _, w2, _ = args
    h = got[1]
    dy = _rand(np.random.default_rng(m), (1, m, dim), cuda)
    bwd = fused_mlp.fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2, **kw)
    want = fused_mlp.fused_mlp_bwd_plain(dy, x, h, gamma, beta, w1, w2, **kw)
    bwd = [t.reshape(w.shape) for t, w in zip(bwd, want)]
    _check_grads(bwd, want, params=(5, 6))


@pytest.mark.parametrize("zero_bias", [True, False])
def test_fused_mlp_kernel_zero_rows(cuda, zero_bias):
    """All-zero rows of x, at a tile's first and last row and in the
    ragged tile: with beta = b1 = 0, u, h and g of those rows are 0 and y
    is bf16(b2) there exactly (dropout 0), and h is 0."""
    rows = (0, 127, 128, 129)
    args = _mlp_args(np.random.default_rng(3), 130, 256, 384, cuda,
                     zero_rows=rows, zero_bias=zero_bias)
    y, h = fused_mlp.fused_mlp_block_cuda(*args, return_h=True)
    _check((y, h), fused_mlp.fused_mlp_block_plain(*args, return_h=True))
    if zero_bias:
        want = args[-1].to(torch.bfloat16).expand(len(rows), -1)
        assert torch.equal(y[0, list(rows)], want)
        assert not h[0, list(rows)].float().abs().max()


@pytest.mark.parametrize("m,dim,hid", [(130, 256, 384), (8008, 1024, 2048)])
def test_fused_mlp_kernel_repeats_and_h(cuda, m, dim, hid):
    """Two calls bit-equal (every sum in a fixed order, no atomics), at
    dropout 0.1 with h; without return_h the call gives the same y and
    allocates no h (its peak is lower by at least h's bytes)."""
    args = _mlp_args(np.random.default_rng(m + 7), m, dim, hid, cuda)
    kw = {"dropout_rate": 0.1, "seeds": (21, 22)}
    before = fused_mlp.fused_mlp_block_cuda.launches
    y, h = fused_mlp.fused_mlp_block_cuda(*args, return_h=True, **kw)
    y2, h2 = fused_mlp.fused_mlp_block_cuda(*args, return_h=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert fused_mlp.fused_mlp_block_cuda.launches == before + 2

    def peak(return_h):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fused_mlp.fused_mlp_block_cuda(*args, return_h=return_h, **kw)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    _, with_h = peak(True)
    y3, without = peak(False)
    assert isinstance(y3, torch.Tensor) and torch.equal(y3, y)
    assert without + h.numel() * h.element_size() <= with_h


@pytest.mark.parametrize("m,dim,hid", [(130, 256, 384), (8008, 1024, 2048),
                                       (300, 1280, 5120)])
def test_fused_mlp_bwd_kernel_repeats(cuda, m, dim, hid):
    """K9 twice on the same operands at dropout 0.1: every output, dgamma
    and dbeta included, bit-equal (sums in a fixed order, no atomics)."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_args(
        np.random.default_rng(m + 11), m, dim, hid, cuda)
    kw = {"dropout_rate": 0.1, "seeds": (23, 24)}
    _, h = fused_mlp.fused_mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2,
                                          return_h=True, **kw)
    dy = _rand(np.random.default_rng(m + 12), (1, m, dim), cuda)
    before = fused_mlp.fused_mlp_bwd_cuda.launches
    one, two = (fused_mlp.fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2,
                                             **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_bwd_cuda.launches == before + 2
    assert all(torch.equal(p, q) for p, q in zip(one, two))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mlp_bwd_kernel_zero_rows(cuda, rate):
    """All-zero rows of dy, at a tile's first and last row and in the
    ragged tile: dz and dh are 0 there, so du is, and dx is 0 exactly; the
    other rows match plain."""
    rows = [0, 127, 128, 129]
    x, gamma, beta, w1, b1, w2, b2 = _mlp_args(np.random.default_rng(5), 130,
                                               256, 384, cuda)
    kw = {"dropout_rate": rate, "seeds": (25, 26)}
    _, h = fused_mlp.fused_mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2,
                                          return_h=True, **kw)
    dy = _rand(np.random.default_rng(6), (1, 130, 256), cuda)
    dy[0, rows] = 0
    got = fused_mlp.fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2, **kw)
    want = fused_mlp.fused_mlp_bwd_plain(dy, x, h, gamma, beta, w1, w2, **kw)
    got = [t.reshape(w.shape) for t, w in zip(got, want)]
    _check_grads(got, want, params=(5, 6))
    dx, _, _, dz, dh, _, _ = got
    assert not dz.reshape(130, -1)[rows].float().abs().max()
    assert not dh.reshape(130, -1)[rows].float().abs().max()
    assert not dx.reshape(130, -1)[rows].float().abs().max()


def test_training_autograd_runs_the_kernels(cuda):
    """A block's forward and backward through the autograd functions
    launches every forward and backward kernel once."""
    from neurovit_tpu_torch.models.vit3d import Attention, FeedForward, ViTConfig

    cfg = ViTConfig(image_size=10, image_patch_size=5, frames=10,
                    frame_patch_size=5, num_classes=2, dim=512, heads=2,
                    dim_head=64, mlp_dim=384)
    attn, ff = Attention(cfg, device=cuda), FeedForward(cfg, device=cuda)
    counted = (fa.flash_attention_cuda, fa.flash_attention_bwd_cuda,
               fused_qkv.fused_ln_qkv_cuda, fused_qkv.fused_ln_qkv_bwd_cuda,
               fused_outproj.fused_outproj_residual_cuda,
               fused_outproj.fused_outproj_bwd_cuda,
               fused_mlp.fused_mlp_block_cuda, fused_mlp.fused_mlp_bwd_cuda)
    before = [fn.launches for fn in counted]
    x = torch.randn(2, 9, 512, device=cuda, dtype=torch.bfloat16)
    y = ff(attn(x, 0.1, (1, 2)), 0.1, (3, 4))
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1] * 8
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in list(attn.parameters()) + list(ff.parameters()))


def test_kernels_refuse_what_they_do_not_take(cuda):
    """An f16 activation, a head dim past the largest instance, and a width
    that is not a multiple of 16; each refusal names ROADMAP.md, Queue 3."""
    x = torch.zeros(1, 4, 512, device=cuda,              # neither bf16
                    dtype=torch.float16)                 # nor f32
    with pytest.raises(TypeError):
        fused_outproj.fused_outproj_residual(
            x, torch.zeros_like(x[..., :128]),
            torch.zeros(512, 128, device=cuda), torch.zeros(512, device=cuda))
    q = torch.zeros(1, 4, 2, 256, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim <= 128.*Queue 3"):
        fa.flash_attention(q, q, q, scale=1.0)
    x = torch.zeros(1, 4, 72, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16.*Queue 3"):
        fused_qkv.fused_ln_qkv(x, torch.ones(72, device=cuda),
                               torch.zeros(72, device=cuda),
                               torch.zeros(96, 72, device=cuda), 2, 16)


def _int8_weight(rng, out_f, in_f, device):
    w = _rand(rng, (out_f, in_f), device, torch.float32, in_f ** -0.5)
    return int8_serving.quantize_weight(w)


def _int8_qkv_args(rng, m, dim, heads, dh, device, zero_rows=(),
                   zero_beta=False):
    """K10's operands for x [1, m, dim]; ``zero_rows`` of x are 0, and
    with ``zero_beta`` beta is 0 too, so those rows quantize an all-zero u
    (amax 0, scale 1, codes 0)."""
    x = _rand(rng, (1, m, dim), device)
    x[0, list(zero_rows)] = 0
    gamma = _rand(rng, (dim,), device, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (dim,), device, torch.float32, 0.1)
    if zero_beta:
        beta.zero_()
    w8, s = _int8_weight(rng, 3 * heads * dh, dim, device)
    return (x, gamma, beta, w8, s, heads, dh)


# K10 on TMA + wgmma: (m, dim, heads, dim_head). Ragged rows (1, 65, 300),
# the flagship's rows at batch 8 (8008 = 62 tiles + 72) and its widths,
# dims up to ViT-H's 1280 and 1536 (refused by the earlier kernel), inners
# that are not a multiple of the 128- or 64-column tile (320, 384: the last
# tile of q and k reads W8's rows of the next section), and grids on both
# sides of the 64-column tile rule.
INT8_QKV_CASES = [(1, 512, 4, 64), (65, 512, 4, 64), (300, 512, 4, 64),
                  (8008, 1024, 8, 64), (300, 64, 4, 80), (65, 384, 6, 64),
                  (130, 1280, 16, 80), (8008, 1280, 16, 80),
                  (300, 1536, 8, 64), (1, 1536, 24, 64), (8008, 384, 4, 80),
                  (2002, 1536, 6, 64)]


@pytest.mark.parametrize("m,dim,heads,dh", INT8_QKV_CASES)
def test_int8_ln_qkv_kernel(cuda, m, dim, heads, dh):
    """K10 against plain, one launch-count a call, and two calls bit-equal
    (every code and sum is in a fixed order)."""
    args = _int8_qkv_args(np.random.default_rng(m + dim + heads * dh), m,
                          dim, heads, dh, cuda)
    before = int8_serving.int8_ln_qkv_cuda.launches
    got = int8_serving.int8_ln_qkv(*args)
    _check(got, int8_serving.int8_ln_qkv_plain(*args))
    again = int8_serving.int8_ln_qkv(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert int8_serving.int8_ln_qkv_cuda.launches == before + 2


@pytest.mark.parametrize("zero_beta", [True, False])
def test_int8_ln_qkv_kernel_zero_rows(cuda, zero_beta):
    """All-zero rows of x, at a tile's first and last row and in the
    ragged tile: with beta = 0, u of those rows is all zero (amax 0, scale
    1, codes 0) and q = k = v = 0 there exactly; an all-zero x gives
    all-zero q, k and v."""
    rows = (0, 127, 128, 129)
    args = _int8_qkv_args(np.random.default_rng(4), 130, 256, 4, 64, cuda,
                          zero_rows=rows, zero_beta=zero_beta)
    got = int8_serving.int8_ln_qkv_cuda(*args)
    _check(got, int8_serving.int8_ln_qkv_plain(*args))
    if zero_beta:
        assert all(not t[0, list(rows)].float().abs().max() for t in got)
        args[0].zero_()
        got = int8_serving.int8_ln_qkv_cuda(*args)
        torch.cuda.synchronize()
        assert all(not t.float().abs().max() for t in got)


def test_int8_qkv_plan_matches_the_kernel(cuda):
    """The wrapper's K10 plan counts the scratch and the GEMM pass's shared
    memory (which follows its tile width) as the kernel does, at every
    width of the matrix and the card tests' widths, on both sides of the
    64-column tile rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch, smem = lib.nvt_int8_qkv_scratch_bytes, lib.nvt_int8_qkv_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[1] * w[2]) for w in WIDTHS.values()] + [
        (d, h * dh) for _, d, h, dh in INT8_QKV_CASES]
    for dim, inner in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032):
            plan = int8_serving.qkv_plan(m, dim, inner)
            assert scratch(m, dim, inner) == plan.scratch_bytes, (m, dim,
                                                                  inner)
            assert [s for *_, s in plan.launches] == [
                0, smem(m, inner)], (m, dim, inner)


@pytest.mark.parametrize("m", [1, 65, 300])
def test_int8_outproj_kernel(cuda, m):
    rng = np.random.default_rng(m + 5)
    x = _rand(rng, (1, m, 512), cuda)
    a = _rand(rng, (1, m, 256), cuda)
    w8, s = _int8_weight(rng, 512, 256, cuda)
    b = _rand(rng, (512,), cuda, torch.float32, 0.05)
    args = (x, a, w8, s, b)
    _check(int8_serving.int8_outproj_residual(*args),
           int8_serving.int8_outproj_residual_plain(*args))


# K11 and K3 on TMA + wgmma: ragged rows (1, 130), the flagship at batch 1
# (64-column tiles) and 8, inner off the 128-wide k box, and the widths
# their wmma versions refused: K11's inner past 1024 (ViT-H 1280, 1536,
# 2048) and K3's inner past 1536 (2048).
OUTPROJ_CASES = [(1, 512, 256), (130, 512, 256), (1001, 1024, 512),
                 (8008, 1024, 512), (130, 384, 320), (130, 1280, 1280),
                 (2002, 1280, 1280), (130, 1536, 1536), (130, 2048, 2048),
                 (1001, 1024, 2048)]


def _outproj_args(rng, m, dim, inner, device):
    """x [1, m, dim], a [1, m, inner], f32 Wout [dim, inner] and b [dim]."""
    return (_rand(rng, (1, m, dim), device), _rand(rng, (1, m, inner), device),
            _rand(rng, (dim, inner), device, torch.float32, inner ** -0.5),
            _rand(rng, (dim,), device, torch.float32, 0.05))


@pytest.mark.parametrize("m,dim,inner", OUTPROJ_CASES)
def test_int8_outproj_kernel_widths(cuda, m, dim, inner):
    """K11 equal to plain bit for bit (the int32 sums are exact and both
    round at the same points), one launch-count a call, two calls equal."""
    x, a, w, b = _outproj_args(np.random.default_rng(m + dim + inner), m,
                               dim, inner, cuda)
    args = (x, a, *int8_serving.quantize_weight(w), b)
    before = int8_serving.int8_outproj_residual_cuda.launches
    got = int8_serving.int8_outproj_residual(*args)
    want = int8_serving.int8_outproj_residual_plain(*args)
    again = int8_serving.int8_outproj_residual(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())
    assert torch.equal(got, again)
    assert int8_serving.int8_outproj_residual_cuda.launches == before + 2


def test_int8_outproj_kernel_zero_rows(cuda):
    """All-zero rows of a, at a tile's first and last row and in the
    ragged tile: amax 0, scale 1, codes 0, so y is bf16(b + x) there."""
    rows = [0, 127, 128, 129]
    x, a, w, b = _outproj_args(np.random.default_rng(9), 130, 512, 256, cuda)
    a[0, rows] = 0
    args = (x, a, *int8_serving.quantize_weight(w), b)
    got = int8_serving.int8_outproj_residual_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_serving.int8_outproj_residual_plain(*args))
    assert torch.equal(got[0, rows], (b + x[0, rows].float()).to(x.dtype))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", OUTPROJ_CASES)
def test_fused_outproj_kernel_widths(cuda, m, dim, inner, rate):
    """K3 against plain (the same mask bits at dropout 0.1, the ragged
    last tile included), one launch-count a call, two calls bit-equal."""
    x, a, w, b = _outproj_args(np.random.default_rng(m + dim + inner + 1),
                               m, dim, inner, cuda)
    w = w.to(torch.bfloat16)
    kw = {"dropout_rate": rate, "seed": 7}
    before = fused_outproj.fused_outproj_residual_cuda.launches
    got = fused_outproj.fused_outproj_residual(x, a, w, b, **kw)
    _check(got, fused_outproj.fused_outproj_residual_plain(x, a, w, b, **kw))
    again = fused_outproj.fused_outproj_residual(x, a, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert fused_outproj.fused_outproj_residual_cuda.launches == before + 2
    if rate:      # the dropped positions are those of the plain mask
        drop = ~nn.keep_mask(7, (m, dim), rate).to(cuda)
        assert torch.equal(got.reshape(m, dim)[drop],
                           x.reshape(m, dim)[drop])


OUTPROJ_BWD_CASES = [
    (1, 512, 256), (130, 512, 256), (1001, 1024, 512), (8008, 1024, 512),
    (130, 1280, 1280), (130, 1536, 1536), (130, 2048, 2048),
    (130, 2048, 512), (130, 1024, 1040), (1001, 1024, 1040),
    *((130, d, h * dh) for d, h, dh, _ in WIDTHS.values())]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", OUTPROJ_BWD_CASES)
def test_fused_outproj_bwd_kernel_widths(cuda, m, dim, inner, rate):
    """K8 against plain: dz bit-equal (dy itself at dropout 0), dattn
    within the backward's tolerance; one launch-count a call, two calls
    bit-equal."""
    rng = np.random.default_rng(m + dim + inner + 3)
    dy = _rand(rng, (1, m, dim), cuda, scale=0.1)
    w = _rand(rng, (dim, inner), cuda, torch.float32,
              inner ** -0.5).to(torch.bfloat16)
    kw = {"dropout_rate": rate, "seed": 7}
    before = fused_outproj.fused_outproj_bwd_cuda.launches
    got = fused_outproj.fused_outproj_bwd_cuda(dy, w, **kw)
    want = fused_outproj.fused_outproj_bwd_plain(dy, w, **kw)
    again = fused_outproj.fused_outproj_bwd_cuda(dy, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    if not rate:
        assert got[1] is dy
    _check_grads(got, want)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert fused_outproj.fused_outproj_bwd_cuda.launches == before + 2


def test_outproj_plans_match_the_kernels(cuda):
    """The wrappers' K3, K11 and K8 plans count the scratch and the GEMM
    pass's shared memory (which follows its tile width) as the kernels do,
    at every width of the matrix and the card tests' widths, on both sides
    of the 64-column tile rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch = lib.nvt_int8_outproj_scratch_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem8, smem = lib.nvt_int8_outproj_smem_bytes, \
        lib.nvt_fused_outproj_smem_bytes
    smem_bwd = lib.nvt_fused_outproj_bwd_smem_bytes
    for fn in (smem8, smem, smem_bwd):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[1] * w[2]) for w in WIDTHS.values()] + [
        (d, i) for _, d, i in OUTPROJ_CASES + OUTPROJ_BWD_CASES]
    for dim, inner in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032):
            plan = int8_serving.int8_outproj_plan(m, dim, inner)
            assert scratch(m, dim, inner) == plan.scratch_bytes, (m, dim,
                                                                  inner)
            assert [s for *_, s in plan.launches] == [0, smem8(m, dim)]
            bplan = fused_outproj.outproj_plan(m, dim, inner)
            assert bplan.launches[0][3] == smem(m, dim), (m, dim, inner)
            for rate in (0.0, 0.1):
                k8 = fused_outproj.outproj_bwd_plan(m, dim, inner, rate)
                assert k8.launches[-1][3] == smem_bwd(m, inner), (m, dim,
                                                                 inner)


@pytest.mark.parametrize("m", [1, 33, 300])
def test_int8_mlp_kernel(cuda, m):
    rng = np.random.default_rng(m + 6)
    x = _rand(rng, (1, m, 256), cuda)
    gamma = _rand(rng, (256,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (256,), cuda, torch.float32, 0.1)
    w1, s1 = _int8_weight(rng, 384, 256, cuda)
    b1 = _rand(rng, (384,), cuda, torch.float32, 0.05)
    w2, s2 = _int8_weight(rng, 256, 384, cuda)
    b2 = _rand(rng, (256,), cuda, torch.float32, 0.05)
    args = (x, gamma, beta, w1, s1, b1, w2, s2, b2)
    _check(int8_serving.int8_mlp_block(*args),
           int8_serving.int8_mlp_block_plain(*args))


def _int8_mlp_args(rng, m, dim, hid, device, zero_rows=(), zero_bias=False):
    """K12's operands for x [1, m, dim]; ``zero_rows`` of x are 0, and
    with ``zero_bias`` beta and b1 are 0 too, so those rows quantize an
    all-zero u and an all-zero g (amax 0, scale 1)."""
    x = _rand(rng, (1, m, dim), device)
    x[0, list(zero_rows)] = 0
    gamma = _rand(rng, (dim,), device, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (dim,), device, torch.float32, 0.1)
    w1, s1 = _int8_weight(rng, hid, dim, device)
    b1 = _rand(rng, (hid,), device, torch.float32, 0.05)
    w2, s2 = _int8_weight(rng, dim, hid, device)
    b2 = _rand(rng, (dim,), device, torch.float32, 0.05)
    if zero_bias:
        beta.zero_()
        b1.zero_()
    return (x, gamma, beta, w1, s1, b1, w2, s2, b2)


# K12 on TMA + wgmma: a ragged last row tile (130), the flagship's rows at
# batch 8 (8008 = 62 tiles + 72), ViT-H and mlp 8192 (refused by the
# earlier kernel), a hid and a dim that are not multiples of the 128-wide
# tile (ragged column tiles in both GEMMs and a K tail in fc2's last box).
INT8_MLP_CASES = [(130, 1024, 2048), (8008, 1024, 2048), (130, 1280, 5120),
                  (130, 64, 8192), (200, 1024, 8192), (65, 336, 1360)]


@pytest.mark.parametrize("m,dim,hid", INT8_MLP_CASES)
def test_int8_mlp_kernel_widths(cuda, m, dim, hid):
    """K12 against plain, one launch-count a call, and two calls bit-equal
    (no atomics: every code and sum is in a fixed order)."""
    args = _int8_mlp_args(np.random.default_rng(m + dim + hid), m, dim, hid,
                          cuda)
    before = int8_serving.int8_mlp_block_cuda.launches
    got = int8_serving.int8_mlp_block(*args)
    _check(got, int8_serving.int8_mlp_block_plain(*args))
    again = int8_serving.int8_mlp_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert int8_serving.int8_mlp_block_cuda.launches == before + 2


@pytest.mark.parametrize("zero_bias", [True, False])
def test_int8_mlp_kernel_zero_rows(cuda, zero_bias):
    """All-zero rows of x, at a tile's first and last row and in the
    ragged tile: with beta = b1 = 0, u and g of those rows are all zero
    (amax 0, scale 1, codes 0) and y is bf16(b2) there exactly."""
    rows = (0, 127, 128, 129)
    args = _int8_mlp_args(np.random.default_rng(3), 130, 256, 384, cuda,
                          zero_rows=rows, zero_bias=zero_bias)
    got = int8_serving.int8_mlp_block_cuda(*args)
    _check(got, int8_serving.int8_mlp_block_plain(*args))
    if zero_bias:
        want = args[-1].to(torch.bfloat16).expand(len(rows), -1)
        assert torch.equal(got[0, list(rows)], want)


def test_int8_mlp_plan_matches_the_kernel(cuda):
    """The wrapper's K12 plan counts the scratch and the GEMM passes'
    shared memory as the kernel does."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch, smem = lib.nvt_int8_mlp_scratch_bytes, lib.nvt_int8_mlp_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, []
    widths = [(w[0], w[3]) for w in WIDTHS.values()] + [
        (d, h) for _, d, h in INT8_MLP_CASES]
    for dim, hid in widths:
        for m in (1, 130, 8008, 32032):
            plan = int8_serving.mlp_plan(m, dim, hid)
            assert scratch(m, dim, hid) == plan.scratch_bytes, (m, dim, hid)
            assert {s for _, _, _, s in plan.launches if s} == {smem()}


INT8_ATTN_CASES = (
    [(1, 1, 1, 3, 64), (2, 70, 70, 3, 64), (2, 130, 97, 3, 64),
     (1, 1001, 900, 3, 64), (8, 1001, 1001, 8, 64), (32, 1001, 1001, 8, 64),
     (8, 1001, 900, 8, 128)]
    + [(1, 130, nv, 2, d) for d in (16, 32, 80, 128) for nv in (1, 97, 130)]
    + [(2, 1001, 1001, 3, d) for d in (16, 32, 80, 128)])


@pytest.mark.parametrize("b,n,n_valid,h,d", INT8_ATTN_CASES)
def test_int8_attention_kernel(cuda, b, n, n_valid, h, d):
    """K13 against its plain version at head dims 16-128 (padded to 64 or
    128), n_valid on and off the 64-key tiles, both block heights (batch 8
    and 32 at 1001 tokens take 128-row blocks); two calls bit-equal; keys
    past n_valid get p8 = 0 and stay out of V's scale."""
    rng = np.random.default_rng(n + 7 * d + b)
    q, k, v = (_rand(rng, (b, n, h, d), cuda) for _ in range(3))
    kw = {"scale": d ** -0.5, "n_valid": n_valid}
    before = int8_serving.int8_flash_attention_cuda.launches
    got = int8_serving.int8_flash_attention(q, k, v, **kw)
    _check(got, int8_serving.int8_flash_attention_plain(q, k, v, **kw))
    assert int8_serving.int8_flash_attention_cuda.launches == before + 1
    assert torch.equal(got, int8_serving.int8_flash_attention(q, k, v, **kw))
    v[:, n_valid:] = 100.0
    assert torch.equal(got, int8_serving.int8_flash_attention(q, k, v, **kw))


def _int8_attention_scratch(q, k, v, n_valid):
    """Run K13's C entry point as its wrapper does and return (o, v8,
    stats), the scratch as the kernel left it."""
    from neurovit_tpu_torch.ops.common import FLOAT, INT, VOID, launch, ptr
    b, n, h, d = q.shape
    plan = int8_serving.int8_attn_plan(b, n, h, d)
    o = torch.empty_like(q)
    v8 = torch.zeros((b * h, d, plan.n_pad), dtype=torch.int8,
                     device=q.device)
    stats = torch.zeros(plan.stats_bytes // 4, dtype=torch.float32,
                        device=q.device)
    launch("nvt_int8_attention", (VOID,) * 6 + (INT,) * 5 + (FLOAT,), q,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(v8), ptr(stats), b, n, h, d,
           n_valid, float(d ** -0.5 * fa.LOG2E))
    torch.cuda.synchronize()
    return o, v8, stats


@pytest.mark.parametrize("n,n_valid,d", [(130, 97, 64), (1001, 900, 128),
                                         (1001, 1001, 64)])
def test_int8_attention_prologue_codes(cuda, n, n_valid, d):
    """The prologue's s_v and codes are the IEEE quotients amax / 127 and
    rint(v / s_v) bit for bit (each f32 quotient taken in f64 and rounded
    once, which is the correctly rounded f32 quotient: torch's division by
    the scalar 127 on the card multiplies by its reciprocal, an ulp away at
    times), and v8 holds the codes transposed and permuted (v8_key_order),
    zero past n_valid, over the key tiles n_valid reaches."""
    rng = np.random.default_rng(n_valid + d)
    q, k, v = (_rand(rng, (2, n, 3, d), cuda) for _ in range(3))
    _, v8, stats = _int8_attention_scratch(q, k, v, n_valid)
    vf = v.permute(0, 2, 1, 3).reshape(6, n, d).double()
    amax = vf[:, :n_valid].abs().amax(dim=1)
    s_v = torch.where(amax > 0, (amax / 127).float(), 1.0)
    assert torch.equal(stats[:6 * d], s_v.reshape(-1))
    codes = torch.clamp(torch.round((vf / s_v[:, None].double()).float()),
                        -127, 127)
    reach = -(-n_valid // 64) * 64
    order = int8_serving.v8_key_order(reach).to(cuda)
    want = torch.zeros(6, reach, d, dtype=torch.int8, device=cuda)
    want[:, :n_valid] = codes[:, :n_valid].to(torch.int8)
    assert torch.equal(v8[:, :, :reach], want[:, order].transpose(1, 2))


def test_int8_attention_all_zero_v(cuda):
    """V all zero: every channel's scale is 1, every code 0, and o is 0."""
    rng = np.random.default_rng(0)
    q, k = (_rand(rng, (2, 1001, 8, 64), cuda) for _ in range(2))
    v = torch.zeros_like(q)
    o, v8, stats = _int8_attention_scratch(q, k, v, 1001)
    assert torch.equal(stats[:16 * 64], torch.ones_like(stats[:16 * 64]))
    assert not v8.any() and not o.any()
    assert not int8_serving.int8_flash_attention(q, k, v, scale=0.125).any()


def test_int8_attention_past_65535_heads(cuda):
    """B * H = 65 544 (B 8193, H 8, N 16, D 16): more (b, h) than a grid's
    y could hold; every head is covered."""
    rng = np.random.default_rng(65544)
    q, k, v = (_rand(rng, (8193, 16, 8, 16), cuda) for _ in range(3))
    kw = {"scale": 0.25, "n_valid": 15}
    _check(int8_serving.int8_flash_attention(q, k, v, **kw),
           int8_serving.int8_flash_attention_plain(q, k, v, **kw))


def test_int8_attention_plan_matches_the_kernel(cuda):
    """The wrapper's K13 plan counts the main kernel's block rows and
    shared memory and the two scratch buffers as the kernel does."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    rows, smem = lib.nvt_int8_attn_block_rows, lib.nvt_int8_attn_smem_bytes
    v8b, statb = lib.nvt_int8_attn_v8_bytes, lib.nvt_int8_attn_stats_bytes
    rows.restype, rows.argtypes = ctypes.c_int, [ctypes.c_int] * 4
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    for fn in (v8b, statb):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 4
    shapes = [(b, 1001, 8, d) for b in (1, 8, 32) for d in (64, 128)] + [
        (b, n, heads, dh) for _, heads, dh, _ in WIDTHS.values()
        for b in (1, 8) for n in (130, 1001)] + [(8193, 16, 8, 16)]
    for b, n, h, d in shapes:
        plan = int8_serving.int8_attn_plan(b, n, h, d)
        dk = plan.d_kernel
        assert rows(b, n, h, dk) == plan.bq, (b, n, h, d)
        assert smem(dk, plan.bq) == plan.launches[2][3], (b, n, h, d)
        assert v8b(b, n, h, dk) == plan.v8_bytes, (b, n, h, d)
        assert statb(b, n, h, dk) == plan.stats_bytes, (b, n, h, d)


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    """A shape each int8 kernel refuses, and an f32 weight."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    bf, i8 = torch.bfloat16, torch.int8
    with pytest.raises(ValueError, match="multiple of 16"):   # dim 72
        int8_serving.int8_ln_qkv(zeros(1, 4, 72, dtype=bf), zeros(72),
                                 zeros(72), zeros(384, 72, dtype=i8),
                                 zeros(384), 2, 64)
    with pytest.raises(ValueError, match="inner as a multiple of 16"):
        int8_serving.int8_outproj_residual(                   # inner 1288
            zeros(1, 4, 256, dtype=bf), zeros(1, 4, 1288, dtype=bf),
            zeros(256, 1288, dtype=i8), zeros(256), zeros(256))
    with pytest.raises(ValueError, match="mlp_dim as a multiple of 16"):
        int8_serving.int8_mlp_block(                          # mlp_dim 264
            zeros(1, 4, 256, dtype=bf), zeros(256), zeros(256),
            zeros(264, 256, dtype=i8), zeros(264), zeros(264),
            zeros(256, 264, dtype=i8), zeros(256), zeros(256))
    q = zeros(1, 4, 2, 256, dtype=bf)
    with pytest.raises(ValueError, match="head dim <= 128"):
        int8_serving.int8_flash_attention(q, q, q, scale=1.0)
    with pytest.raises(TypeError):                            # f32 weight
        int8_serving.int8_outproj_residual(
            zeros(1, 4, 512, dtype=bf), zeros(1, 4, 256, dtype=bf),
            zeros(512, 256), zeros(512), zeros(512))


def _pool_input(rng, shape, kind: str, device, dtype):
    if kind == "ties":     # post-ReLU zeros and small integers: most tie
        a = np.maximum(rng.integers(-3, 4, shape), 0)
    else:
        a = rng.standard_normal(shape)
    if kind == "nan_inf":  # 3 % NaN, 3 % +inf, 6 % -inf
        pick = rng.random(shape)
        a[pick < 0.03] = np.nan
        a[(pick >= 0.03) & (pick < 0.06)] = np.inf
        a[(pick >= 0.06) & (pick < 0.12)] = -np.inf
    return torch.tensor(a, dtype=dtype, device=device)


def _same_or_nan(got, want):
    """Equal values, and NaN exactly where the plain version has NaN (a
    NaN's bits may differ: each conversion rounds it to its own NaN)."""
    nan = torch.isnan(want)
    assert got.dtype == want.dtype and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


# The card tests' four shapes; C = 3, whose rows take ordinary loads; B * D
# = 65700, past the old grid's 65535; the stem at batch 1.
POOL_SHAPES = [(2, 9, 7, 10, 8), (1, 8, 8, 8, 4), (2, 5, 6, 9, 16),
               (2, 18, 9, 9, 64), (2, 9, 7, 45, 3), (730, 90, 1, 1, 8),
               (1, 90, 45, 45, 64)]


def _launch_pool(name, p, ops, shape, dtype):
    """K14 (``nvt_maxpool3d_fwd`` on x, out, codes) or K15
    (``nvt_maxpool3d_bwd`` on codes, g, dx) on the walk ``p``."""
    from neurovit_tpu_torch.ops.common import INT, VOID, launch, ptr
    launch(name, (VOID,) * 3 + (INT,) * 13, ops[0], *(ptr(t) for t in ops),
           *shape, int(dtype == torch.bfloat16), p.rows, p.cols, p.chans,
           p.chunks, p.slots, int(p.bulk), p.grid)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["continuous", "ties", "nan_inf"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_maxpool_kernels(cuda, shape, kind, dtype):
    rng = np.random.default_rng(sum(shape))
    x = _pool_input(rng, shape, kind, cuda, dtype)
    before = (maxpool3d.max_pool3d_argmax_cuda.launches,
              maxpool3d.max_pool3d_argmax_bwd_cuda.launches)
    out, codes = maxpool3d.max_pool3d_argmax(x)
    want, want_codes = maxpool3d.max_pool3d_argmax_plain(x)
    torch.cuda.synchronize()
    _same_or_nan(out, want)
    assert torch.equal(codes, want_codes)
    g = _pool_input(rng, tuple(out.shape), "continuous", cuda, dtype)
    dx = maxpool3d.max_pool3d_argmax_bwd(codes, g, shape, dtype)
    want_dx = maxpool3d.max_pool3d_argmax_bwd_plain(codes, g, shape, dtype)
    torch.cuda.synchronize()
    assert torch.equal(dx, want_dx)
    assert (maxpool3d.max_pool3d_argmax_cuda.launches,
            maxpool3d.max_pool3d_argmax_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 9, 7, 10, 8), (2, 5, 6, 9, 32),
                                   (2, 9, 7, 45, 3)])
def test_maxpool_tiled_walks(cuda, shape, dtype):
    """The kernels on walks the stem never takes, bit-equal to plain: one
    SM's grid, so a block's ring runs through many items; the ordinary-load
    path on the planned tile; tiles of 2 output columns and, at C = 32, 16
    channels, on 3 blocks, by bulk copies where the runs are 16-byte
    ones (a copy each row's columns, or each column's channels)."""
    rng = np.random.default_rng(3)
    x = _pool_input(rng, shape, "ties", cuda, dtype)
    want, want_codes = maxpool3d.max_pool3d_argmax_plain(x)
    g = _pool_input(rng, tuple(want.shape), "continuous", cuda, dtype)
    want_dx = maxpool3d.max_pool3d_argmax_bwd_plain(want_codes, g, shape,
                                                   dtype)
    plan = maxpool3d.pool_plan(shape, dtype, sms=1)
    walks = [plan, maxpool3d.PoolPlan(*(p._replace(bulk=False)
                                        for p in plan))]
    c = shape[4]
    if c % 8 == 0:
        chans = 16 if c == 32 else c
        elts = {"fwd": (dtype.itemsize,), "bwd": (dtype.itemsize, 1)}
        walks.append(maxpool3d.PoolPlan(*(p._replace(
            cols=2, chans=chans, grid=3, bulk=maxpool3d._bulk_ok(
                0, c, chans, False, elts[kind]))
            for kind, p in zip(("fwd", "bwd"), plan))))
    for walk in walks:
        out, codes = torch.empty_like(want), torch.empty_like(want_codes)
        dx = torch.empty_like(x)
        _launch_pool("nvt_maxpool3d_fwd", walk.fwd, (x, out, codes), shape,
                     dtype)
        _launch_pool("nvt_maxpool3d_bwd", walk.bwd, (want_codes, g, dx),
                     shape, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(codes, want_codes)
        assert torch.equal(dx, want_dx), walk


def test_maxpool_plan_smem_is_the_kernels(cuda):
    """pool_plan's shared memory is what the kernels' launch asks for
    (``nvt_maxpool3d_smem_bytes``, the count the launcher sizes the launch
    with), and a bulk walk on rows that are not 16-byte runs is refused."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_maxpool3d_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 9
    for shape in POOL_SHAPES + [(8, 90, 45, 45, 64), (64, 90, 45, 45, 64),
                                (1, 6, 4, 900, 64), (1, 4, 4, 4, 4096)]:
        for dtype in (torch.bfloat16, torch.float32):
            plan = maxpool3d.pool_plan(shape, dtype)
            for fwd, p in ((1, plan.fwd), (0, plan.bwd)):
                assert fn(fwd, *shape[2:], int(dtype == torch.bfloat16),
                          p.rows, p.cols, p.chans, p.slots) == p.smem_bytes
    shape = (2, 9, 7, 45, 3)
    x = torch.zeros(shape, device=cuda)
    out = torch.empty(2, 5, 4, 23, 3, device=cuda)
    codes = torch.empty(out.shape, dtype=torch.uint8, device=cuda)
    p = maxpool3d.pool_plan(shape, x.dtype).fwd
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch_pool("nvt_maxpool3d_fwd", p._replace(bulk=True),
                     (x, out, codes), shape, x.dtype)


def test_maxpool_autograd_and_resnet_forward_backward(cuda):
    """The autograd Function launches K14 once and K15 once; a small
    ResNet's train-mode gradients on the card (K14, K15 and cuDNN, with the
    global TF32 flag at its default: the convs turn it off themselves)
    against the same weights on the CPU plain path. f32 within 5e-3
    relative Frobenius error (f32 sums in another order, amplified by the
    train-mode BatchNorms' backward; chip_smoke.py's full ResNet-18 reads
    4e-3 to 7e-3). bf16 gradients of this model are 20-30 % from its f32
    ones on the CPU alone, so the card's bf16 gradients are held to be no
    farther from the CPU's f32 ones than the CPU's bf16 gradients are (1.5x
    plus 2e-2, worst and median parameter, as chip_smoke.py holds them)."""
    from neurovit_tpu_torch.models import resnet3d
    x = _pool_input(np.random.default_rng(1), (2, 8, 8, 8, 64), "ties",
                    cuda, torch.bfloat16).requires_grad_()
    before = maxpool3d.max_pool3d_argmax_bwd_cuda.launches
    maxpool3d.max_pool3d(x).float().sum().backward()
    assert maxpool3d.max_pool3d_argmax_bwd_cuda.launches == before + 1
    assert float(x.grad.float().sum()) == 2 * 4 * 4 * 4 * 64

    cfg = resnet3d.ResNetConfig(depth=10, n_classes=2, widen_factor=0.25)
    init = resnet3d.ResNet3D(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    vol = torch.randn(4, 1, 16, 40, 40, generator=torch.Generator(
        ).manual_seed(1))
    assert torch.backends.cudnn.allow_tf32
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for dev in (cuda, torch.device("cpu")):
            model = resnet3d.ResNet3D(cfg, device=dev)
            model.load_state_dict(init.state_dict())
            model(vol.to(dev, dtype), train=True).square().sum().backward()
            grads[dtype, dev.type] = {n: p.grad.float().cpu()
                                      for n, p in model.named_parameters()}
    assert torch.backends.cudnn.allow_tf32

    def errs(got, want):
        return np.array([float((got[n] - w).norm() / w.norm())
                         for n, w in want.items()])

    f32 = grads[torch.float32, "cpu"]
    assert errs(grads[torch.float32, "cuda"], f32).max() <= 5e-3
    card = errs(grads[torch.bfloat16, "cuda"], f32)
    plain = errs(grads[torch.bfloat16, "cpu"], f32)
    for stat in (np.max, np.median):
        assert stat(card) <= 1.5 * stat(plain) + 2e-2, (stat, card, plain)


# ---------------------------------------------------------------------------
# Every ViT width of the matrix (neurovit_tpu_torch.models.vit3d.WIDTHS)
# through every block kernel, against the plain versions: one volume of 130
# tokens (a ragged 64-row and 64-key edge), n_valid 97 for the attention.
# ---------------------------------------------------------------------------

def _block(rng, width, device, m=130):
    dim, heads, dh, hid = WIDTHS[width]
    inner = heads * dh

    def w(out_f, in_f):
        return _rand(rng, (out_f, in_f), device, torch.float32, in_f ** -0.5)

    return dict(
        x=_rand(rng, (1, m, dim), device), heads=heads, dh=dh,
        ln=(_rand(rng, (dim,), device, torch.float32, 0.1, 1.0),
            _rand(rng, (dim,), device, torch.float32, 0.1)),
        wqkv=w(3 * inner, dim), wout=w(dim, inner),
        bout=_rand(rng, (dim,), device, torch.float32, 0.05),
        attn=_rand(rng, (1, m, inner), device), w1=w(hid, dim),
        b1=_rand(rng, (hid,), device, torch.float32, 0.05), w2=w(dim, hid),
        b2=_rand(rng, (dim,), device, torch.float32, 0.05),
        qkv=[_rand(rng, (1, m, heads, dh), device) for _ in range(3)],
        dy=_rand(rng, (1, m, dim), device, scale=0.1))


WIDTH_NAMES = ["smoke", "hd32", "vit_s", "vit_b", "vit_l", "hd128", "hd80",
               "flagship"]


@pytest.mark.parametrize("width", WIDTH_NAMES)
def test_widths_bf16_kernels(cuda, width):
    """K1-K9 and K6 at one width, with dropout 0.1 where the op has it."""
    p = _block(np.random.default_rng(len(width)), width, cuda)
    x, ln, heads, dh = p["x"], p["ln"], p["heads"], p["dh"]
    wqkv = p["wqkv"].to(torch.bfloat16)
    _check(fused_qkv.fused_ln_qkv_cuda(x, *ln, wqkv, heads, dh, return_u=True),
           fused_qkv.fused_ln_qkv_plain(x, *ln, wqkv, heads, dh,
                                        return_u=True))
    dqkv = torch.cat([t.reshape(*x.shape[:2], -1) * 0.1 for t in p["qkv"]],
                     dim=2)
    _check_grads(fused_qkv.fused_ln_qkv_bwd_cuda(dqkv, x, ln[0], wqkv),
                 fused_qkv.fused_ln_qkv_bwd_plain(dqkv, x, ln[0], wqkv),
                 params=(1, 2))
    kw = {"scale": dh ** -0.5, "n_valid": 97, "dropout_rate": 0.1, "seed": 3}
    q, k, v = p["qkv"]
    o, lsum = fa.flash_attention_cuda(q, k, v, return_stats=True, **kw)
    o_p, lsum_p = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
    _check((o,), (o_p,))
    do = p["qkv"][0].flip(1).contiguous()
    _check_grads(fa.flash_attention_bwd_cuda(q, k, v, o_p, do, lsum_p, **kw),
                 fa.flash_attention_bwd_plain(q, k, v, o_p, do, lsum_p, **kw))
    qh, kh, vh, doh, oh = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do, o_p))
    _check(fa.flash_attention_bhnd_cuda(qh, kh, vh, **kw),
           fa.flash_attention_bhnd_plain(qh, kh, vh, **kw))
    _check_grads(
        fa.flash_attention_bhnd_bwd_cuda(qh, kh, vh, oh, doh, lsum_p, **kw),
        fa.flash_attention_bhnd_bwd_plain(qh, kh, vh, oh, doh, lsum_p, **kw))
    drop = {"dropout_rate": 0.1, "seed": 4}
    out = (x, p["attn"], p["wout"].to(torch.bfloat16), p["bout"])
    _check(fused_outproj.fused_outproj_residual_cuda(*out, **drop),
           fused_outproj.fused_outproj_residual_plain(*out, **drop))
    _check_grads(fused_outproj.fused_outproj_bwd_cuda(p["dy"], out[2], **drop),
                 fused_outproj.fused_outproj_bwd_plain(p["dy"], out[2], **drop))
    w1, w2 = p["w1"].to(torch.bfloat16), p["w2"].to(torch.bfloat16)
    mlp = (x, *ln, w1, p["b1"], w2, p["b2"])
    mkw = {"dropout_rate": 0.1, "seeds": (5, 6)}
    _check(fused_mlp.fused_mlp_block_cuda(*mlp, return_h=True, **mkw),
           fused_mlp.fused_mlp_block_plain(*mlp, return_h=True, **mkw))
    _, h = fused_mlp.fused_mlp_block_plain(*mlp, return_h=True, **mkw)
    got = fused_mlp.fused_mlp_bwd_cuda(p["dy"], x, h, *ln, w1, w2, **mkw)
    want = fused_mlp.fused_mlp_bwd_plain(p["dy"], x, h, *ln, w1, w2, **mkw)
    _check_grads([t.reshape(w.shape) for t, w in zip(got, want)], want,
                 params=(5, 6))


@pytest.mark.parametrize("width", WIDTH_NAMES)
def test_widths_int8_kernels(cuda, width):
    """K10-K13 at one width."""
    p = _block(np.random.default_rng(len(width) + 50), width, cuda)
    x, ln, heads, dh = p["x"], p["ln"], p["heads"], p["dh"]
    q8 = int8_serving
    qkv8 = q8.quantize_weight(p["wqkv"])
    _check(q8.int8_ln_qkv_cuda(x, *ln, *qkv8, heads, dh),
           q8.int8_ln_qkv_plain(x, *ln, *qkv8, heads, dh))
    out8 = q8.quantize_weight(p["wout"])
    _check(q8.int8_outproj_residual_cuda(x, p["attn"], *out8, p["bout"]),
           q8.int8_outproj_residual_plain(x, p["attn"], *out8, p["bout"]))
    mlp8 = (*q8.quantize_weight(p["w1"]), p["b1"],
            *q8.quantize_weight(p["w2"]), p["b2"])
    _check(q8.int8_mlp_block_cuda(x, *ln, *mlp8),
           q8.int8_mlp_block_plain(x, *ln, *mlp8))
    kw = {"scale": dh ** -0.5, "n_valid": 97}
    _check(q8.int8_flash_attention_cuda(*p["qkv"], **kw),
           q8.int8_flash_attention_plain(*p["qkv"], **kw))


def test_mlp_smem_plan_matches_the_kernel(cuda):
    """The wrapper's K4 plan (``mlp_plan``) counts the scratch and the GEMM
    passes' shared memory (which follows each pass's tile width) as the
    kernel does, at every width of the matrix and the card tests' widths,
    at row counts on both sides of the 64-column tile rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch = lib.nvt_fused_mlp_scratch_bytes
    smem = lib.nvt_fused_mlp_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[3]) for w in WIDTHS.values()] + MLP_WIDTHS
    for dim, hid in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032):
            plan = fused_mlp.mlp_plan(m, dim, hid)
            assert scratch(m, dim, hid) == plan.scratch_bytes, (m, dim, hid)
            assert [s for *_, s in plan.launches] == [
                0, smem(m, hid), smem(m, dim)], (m, dim, hid)


def test_mlp_bwd_plan_matches_the_kernel(cuda):
    """The wrapper's K9 plan (``mlp_bwd_plan``) counts the scratch and the
    GEMM passes' shared memory as the kernel does, at every width of the
    matrix and the card tests' widths, on both sides of the 64-column tile
    rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch = lib.nvt_fused_mlp_bwd_scratch_bytes
    smem = lib.nvt_fused_mlp_bwd_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[3]) for w in WIDTHS.values()] + MLP_WIDTHS
    for dim, hid in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032):
            plan = fused_mlp.mlp_bwd_plan(m, dim, hid)
            assert scratch(m, dim, hid) == plan.scratch_bytes, (m, dim, hid)
            assert [s for *_, s in plan.launches] == [
                0, smem(m, hid), smem(m, dim), 0, 0], (m, dim, hid)


def test_qkv_bwd_plan_matches_the_kernel(cuda):
    """The wrapper's K7 plan (``qkv_bwd_plan``) counts the scratch and the
    du pass's shared memory as the kernel does, at every width of the
    matrix and the card tests' widths, on both sides of the 64-column tile
    rule."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    scratch = lib.nvt_fused_ln_qkv_bwd_scratch_bytes
    smem = lib.nvt_fused_ln_qkv_bwd_smem_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    widths = [(w[0], w[1] * w[2]) for w in WIDTHS.values()] + QKV_BWD_WIDTHS
    for dim, inner in widths:
        for m in (1, 130, 1001, 2048, 8008, 32032, 128128):
            plan = fused_qkv.qkv_bwd_plan(m, dim, inner)
            assert scratch(m, dim, inner) == plan.scratch_bytes, (m, dim,
                                                                  inner)
            assert [s for *_, s in plan.launches] == [
                0, smem(m, dim), 0, 0], (m, dim, inner)


def test_head_dim_below_8_runs_plain_on_the_card(cuda):
    """Head dim < 8 (the 4D temporal layer's 1) takes the plain attention on
    the card, chosen by shape, and launches no kernel."""
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, (2, 7, 2, 1), cuda).requires_grad_()
               for _ in range(3))
    before = fa.flash_attention_cuda.launches
    o = fa.flash_attention(q, k, v, scale=1.0, dropout_rate=0.1, seed=2)
    o.float().sum().backward()
    assert fa.flash_attention_cuda.launches == before
    want = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                    scale=1.0, dropout_rate=0.1, seed=2)
    assert torch.equal(o, want) and q.grad is not None


# ---------------------------------------------------------------------------
# K16-K18, the probes' kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(7,), (3, 1001, 64), (1024, 2048)])
def test_dropout_kernel_bit_equal(cuda, shape, dtype):
    """K16 forward and backward equal the plain version bit for bit (the
    same words, the same rounding)."""
    from neurovit_tpu_torch.ops import dropout as dr
    rng = np.random.default_rng(len(shape))
    x = _rand(rng, shape, cuda, dtype).requires_grad_()
    before = dr.dropout_cuda.launches
    y = dr.dropout(x, 0.1, 1234)
    g = _rand(rng, shape, cuda, dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert dr.dropout_cuda.launches == before + 2
    assert torch.equal(y, dr.dropout_plain(x.detach(), 0.1, 1234))
    assert torch.equal(x.grad, dr.dropout_plain(g, 0.1, 1234))


# K = 128 and 256 (one and two int8 boxes), the probe's shapes in small:
# K = 64 (one k tile, attn_qk), N = 64 (the 64 x 64 instance, attn_pv),
# N = 48 and 320 (ragged N on both instances), M = 144 (ragged M), K = 80
# (a K tail inside one 128-byte box), K = 4096 (bf16 sums over a long K), and
# the 16 x 16 x 16 corner (boxes larger than the whole operand).
GEMM_CASES = [(128, 128, 128), (128, 256, 128), (512, 256, 256),
              (256, 1024, 64), (144, 80, 48), (128, 64, 1024),
              (144, 80, 320), (256, 4096, 192), (16, 16, 16)]


@pytest.mark.parametrize("m,k,n", GEMM_CASES)
def test_gemm_kernels(cuda, m, k, n):
    """K17 int8 and K18 bit-equal to their plain versions, K17 bf16 within
    K 2^-23 sum|a||b| elementwise (f32 sums in another order), each kernel
    launched once."""
    from neurovit_tpu_torch.ops import int8_gemm as g
    rng = np.random.default_rng(m + k + n)
    a8 = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8,
                      device=cuda)
    b8 = torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8,
                      device=cuda)
    sa = torch.tensor(rng.random(m) + 0.5, dtype=torch.float32, device=cuda)
    sb = torch.tensor(rng.random(n) + 0.5, dtype=torch.float32, device=cuda)
    before = (g.gemm_int8_cuda.launches, g.gemm_bf16_cuda.launches,
              g.dynquant_matmul_cuda.launches)
    assert torch.equal(g.blocked_matmul(a8, b8),
                       g.blocked_matmul_plain(a8, b8))
    assert torch.equal(g.dynquant_matmul(a8, b8, sa, sb),
                       g.dynquant_matmul_plain(a8, b8, sa, sb))
    a, b = _rand(rng, (m, k), cuda), _rand(rng, (k, n), cuda)
    got, want = g.blocked_matmul(a, b), g.blocked_matmul_plain(a, b)
    bound = k * 2.0 ** -23 * (a.float().abs() @ b.float().abs())
    assert got.dtype == torch.float32 and ((got - want).abs() <= bound).all()
    assert (g.gemm_int8_cuda.launches, g.gemm_bf16_cuda.launches,
            g.dynquant_matmul_cuda.launches) == tuple(x + 1 for x in before)


def test_gemm_smem_plan_matches_the_kernel(cuda):
    """The wrapper's K17/K18 plan counts the shared-memory bytes the kernel
    asks for, at the probe's shapes and the test's."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    from neurovit_tpu_torch.ops import int8_gemm as g
    fn = _build.library().nvt_gemm_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    shapes = [(m, k, n) for _, m, k, n in _gemm_bench().SHAPES] + GEMM_CASES
    for m, k, n in shapes:
        for dtype in g.DTYPES:
            plan = g.gemm_plan(m, n, k, dtype)
            assert fn(plan.bm, plan.bn) == plan.smem, (m, k, n, dtype)


def _gemm_bench():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_int8_gemm_bench.py")
    spec = importlib.util.spec_from_file_location("torch_int8_gemm_bench",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# K1/K6, the attention forward on TMA + wgmma: head dims (16 and 32 through
# the zero pad to 64, 80 through the pad to 128), token counts, n_valid on
# and next to the 64-key tile edges, dropout, grids under and over the
# card's 132 SMs, and a descriptor probe.
# ---------------------------------------------------------------------------

FWD_EDGES = (1, 63, 64, 65, 127, 128, 129, 900)
FWD_CASES = [(d, n, nv) for d in (16, 32, 64, 80, 128) for n in (64, 130, 1001)
             for nv in sorted({e for e in FWD_EDGES if e <= n} | {n})]


def _fwd_both_layouts(q, k, v, kw):
    """K6 on q, k, v [B, H, N, D] against its plain version, and K1 on the
    transposed inputs equal to it bit for bit (the same bits, the same
    arithmetic), o and the row sums; each launched once."""
    before = (fa.flash_attention_cuda.launches,
              fa.flash_attention_bhnd_cuda.launches)
    o, lsum = fa.flash_attention_bhnd_cuda(q, k, v, return_stats=True, **kw)
    o_p, lsum_p = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True,
                                                **kw)
    _check((o,), (o_p,))
    assert torch.allclose(lsum, lsum_p, rtol=1e-5)

    def tr(t):
        return t.transpose(1, 2).contiguous()

    o1, lsum1 = fa.flash_attention_cuda(tr(q), tr(k), tr(v),
                                        return_stats=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, tr(o1)) and torch.equal(lsum, lsum1)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bhnd_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    return o, o_p


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,n,n_valid", FWD_CASES)
def test_flash_fwd_edges(cuda, d, n, n_valid, rate):
    rng = np.random.default_rng(d * 7 + n + n_valid)
    q, k, v = (_rand(rng, (1, 2, n, d), cuda) for _ in range(3))
    _fwd_both_layouts(q, k, v, {"scale": d ** -0.5, "n_valid": n_valid,
                                "dropout_rate": rate, "seed": 41})


@pytest.mark.parametrize("b,h,n,d", [(1, 8, 1001, 64), (8, 8, 1001, 64),
                                     (3, 11, 130, 64), (40, 4, 130, 128),
                                     (2, 3, 70, 64)])
def test_flash_fwd_grids(cuda, b, h, n, d):
    """Grids of 64-row blocks (B H ceil(N / 128) under 132) and of 128-row
    blocks, with the kernel's own choice equal to the plan's."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_flash_fwd_block_rows
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    assert fn(b, n, h) == fa.flash_fwd_plan(b, n, h, d, "bhnd").bq
    rng = np.random.default_rng(b * h + n)
    q, k, v = (_rand(rng, (b, h, n, d), cuda) for _ in range(3))
    for rate in (0.0, 0.1):
        _fwd_both_layouts(q, k, v, {"scale": d ** -0.5, "n_valid": n - 3,
                                    "dropout_rate": rate, "seed": 43})


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_fwd_descriptor_probe(cuda, d, rate):
    """V one-hot by key (v[key] = e_(key mod D)) and integer scores in the
    exp2 domain (q, k in {-1, 0, 1}, scale 1 / log2 e), so p = 2^s is exact
    and column c of o sums p over the keys = c mod D: a V or P laid out
    transposed or mis-swizzled moves whole columns."""
    rng = np.random.default_rng(d)
    n = 130
    keys = torch.arange(n, device=cuda)
    v = torch.zeros(1, 2, n, d, dtype=torch.bfloat16, device=cuda)
    v[:, :, keys, keys % d] = 1
    q, k = (torch.tensor(rng.integers(-1, 2, (1, 2, n, d)) * (
        rng.random((1, 2, n, d)) < 4 / d), dtype=torch.bfloat16, device=cuda)
        for _ in range(2))
    kw = {"scale": 1 / fa.LOG2E, "n_valid": 129, "dropout_rate": rate,
          "seed": 44}
    o, o_p = _fwd_both_layouts(q, k, v, kw)
    err = (o.float() - o_p.float()).abs().amax(dim=(0, 1, 2))
    assert (err <= 2 ** -8).all(), err


def test_flash_fwd_smem_plan_matches_the_kernel(cuda):
    """The wrapper's forward plan counts the shared-memory bytes the kernel
    asks for, at every head dim and block height."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_flash_fwd_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    for b, n, h, d in [(1, 1001, 8, 64), (8, 1001, 8, 64), (1, 1001, 8, 128),
                       (8, 1001, 8, 128), (1, 130, 2, 16), (8, 1001, 8, 80)]:
        plan = fa.flash_fwd_plan(b, n, h, d, "bnhd")
        assert fn(plan.d_kernel, plan.bq) == plan.smem, (b, n, h, d)


# ---------------------------------------------------------------------------
# K5/K6's backward on TMA + wgmma: head dims (16 and 32 through the zero pad
# to 64, 80 through the pad to 128), token counts, n_valid on and next to
# the 64- and 128-key tile edges, dropout, both block heights, repeat calls
# bit for bit, a descriptor probe, its shared-memory plan; and B * H past
# 65535 through the forward and the backward.
# ---------------------------------------------------------------------------

def _bwd_both_layouts(q, k, v, do, kw):
    """K6's backward on q, k, v, dO [B, H, N, D] (residuals from the plain
    forward) against its plain version, dK and dV exact zeros past
    n_valid, a second call equal bit for bit, and K5 on the transposed
    inputs equal to it bit for bit; launched as counted."""
    o_p, lsum_p = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True,
                                                **kw)
    before = (fa.flash_attention_bwd_cuda.launches,
              fa.flash_attention_bhnd_bwd_cuda.launches)
    got = fa.flash_attention_bhnd_bwd_cuda(q, k, v, o_p, do, lsum_p, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(q, k, v, o_p, do, lsum_p, **kw)
    _check_grads(got, want)
    nv = kw["n_valid"]
    assert not got[1][:, :, nv:].any() and not got[2][:, :, nv:].any()
    again = fa.flash_attention_bhnd_bwd_cuda(q, k, v, o_p, do, lsum_p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))

    def tr(t):
        return t.transpose(1, 2).contiguous()

    got1 = fa.flash_attention_bwd_cuda(tr(q), tr(k), tr(v), tr(o_p), tr(do),
                                       lsum_p, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, tr(g1)) for g, g1 in zip(got, got1))
    assert (fa.flash_attention_bwd_cuda.launches,
            fa.flash_attention_bhnd_bwd_cuda.launches) == (before[0] + 1,
                                                           before[1] + 2)
    return got, want


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,n,n_valid", FWD_CASES)
def test_flash_bwd_edges(cuda, d, n, n_valid, rate):
    rng = np.random.default_rng(d * 11 + n + n_valid)
    q, k, v, do = (_rand(rng, (1, 2, n, d), cuda) for _ in range(4))
    _bwd_both_layouts(q, k, v, do, {"scale": d ** -0.5, "n_valid": n_valid,
                                    "dropout_rate": rate, "seed": 45})


@pytest.mark.parametrize("b,h,n,d", [(1, 8, 1001, 64), (8, 8, 1001, 64),
                                     (3, 11, 130, 64), (40, 4, 130, 128),
                                     (2, 3, 70, 64), (2, 8, 1001, 128)])
def test_flash_bwd_grids(cuda, b, h, n, d):
    """Both passes on 64-row blocks (B H ceil(N / 128) under 132) and on
    128-row blocks, with the kernel's own choice equal to the plan's."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_flash_bwd_block_rows
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    assert fn(b, n, h) == fa.flash_bwd_plan(b, n, h, d, "bhnd").rows
    rng = np.random.default_rng(b * h + n + 1)
    q, k, v, do = (_rand(rng, (b, h, n, d), cuda) for _ in range(4))
    for rate in (0.0, 0.1):
        _bwd_both_layouts(q, k, v, do, {"scale": d ** -0.5, "n_valid": n - 3,
                                        "dropout_rate": rate, "seed": 46})


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_bwd_descriptor_probe(cuda, d, rate):
    """dO one-hot by query (do[q] = e_(q mod D)) and integer scores in the
    exp2 domain (q, k in {-1, 0, 1}, scale 1 / log2 e): column c of dV sums
    P^T m over the queries = c mod D, so a dO read transposed or
    mis-swizzled as pass 2's MN-major B operand moves whole columns of dV;
    dP = dO V^T picks one column of V a query, and dQ = dS K reads K as
    pass 1's MN-major operand."""
    rng = np.random.default_rng(d + 1)
    n = 130
    queries = torch.arange(n, device=cuda)
    do = torch.zeros(1, 2, n, d, dtype=torch.bfloat16, device=cuda)
    do[:, :, queries, queries % d] = 1
    q, k = (torch.tensor(rng.integers(-1, 2, (1, 2, n, d)) * (
        rng.random((1, 2, n, d)) < 4 / d), dtype=torch.bfloat16, device=cuda)
        for _ in range(2))
    v = _rand(rng, (1, 2, n, d), cuda)
    got, want = _bwd_both_layouts(q, k, v, do, {
        "scale": 1 / fa.LOG2E, "n_valid": 129, "dropout_rate": rate,
        "seed": 47})
    dv, dv_p = got[2].float(), want[2].float()
    err = (dv - dv_p).abs().amax(dim=(0, 1, 2))
    assert (err <= 1e-4 + 2 ** -6 * dv_p.abs().amax()).all(), err


def test_flash_bwd_smem_plan_matches_the_kernel(cuda):
    """The wrapper's backward plan counts the shared-memory bytes each pass
    asks for, at every head dim and block height."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_flash_bwd_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    for b, n, h, d in [(1, 1001, 8, 64), (8, 1001, 8, 64), (1, 1001, 8, 128),
                       (8, 1001, 8, 128), (1, 130, 2, 16), (8, 1001, 8, 80)]:
        plan = fa.flash_bwd_plan(b, n, h, d, "bnhd")
        assert fn(plan.d_kernel, plan.rows, 1) == plan.dq_smem, (b, n, h, d)
        assert fn(plan.d_kernel, plan.rows, 2) == plan.dkv_smem, (b, n, h, d)


def test_flash_attention_past_65535_heads(cuda):
    """B * H = 65 544 (B 8193, H 8, N 16, D 16): more (b, h) than a grid's
    y could hold; the forward and the backward cover every head."""
    rng = np.random.default_rng(65544)
    q, k, v, do = (_rand(rng, (8193, 8, 16, 16), cuda) for _ in range(4))
    kw = {"scale": 0.25, "n_valid": 15, "dropout_rate": 0.1, "seed": 48}
    _fwd_both_layouts(q, k, v, kw)
    _bwd_both_layouts(q, k, v, do, kw)


# The 4D path: the frozen ViT over B·T volumes, the temporal head, the
# int8 encoder and the ResNet encoder, at the smoke model's widths (dim
# 64, 4 heads of 16, MLP 128, depth 2) on 20^3 volumes.

FOURD_BF16 = (fa.flash_attention_cuda, fused_qkv.fused_ln_qkv_cuda,
              fused_outproj.fused_outproj_residual_cuda,
              fused_mlp.fused_mlp_block_cuda)
FOURD_BWD = (fa.flash_attention_bwd_cuda, fused_qkv.fused_ln_qkv_bwd_cuda,
             fused_outproj.fused_outproj_bwd_cuda, fused_mlp.fused_mlp_bwd_cuda)
FOURD_INT8 = (int8_serving.int8_ln_qkv_cuda,
              int8_serving.int8_outproj_residual_cuda,
              int8_serving.int8_mlp_block_cuda,
              int8_serving.int8_flash_attention_cuda)


def _fourd_config(**extra):
    from neurovit_tpu_torch.config import load_config
    return load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "TRAINING_DIM": 4, "DATASET_NAME": "adni4D", "MODEL_VIT_DIM": 64,
        "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "TRAINING_PRECISION": "bf16", **extra})


def _launches(fns):
    return [fn.launches for fn in fns]


def _fourd_pair(cuda, **extra):
    from neurovit_tpu_torch.models import NeuroEncoder
    config = _fourd_config(**extra)
    model = NeuroEncoder(config, device=cuda, seed=3)
    cpu = NeuroEncoder(config, device="cpu", seed=3)
    return model, cpu


def _fourd_seqs(b=2, t=5):
    x = np.random.default_rng(t).standard_normal((b, 20, 20, 20, t))
    for i in range(t):
        x[:, 2 + 2 * i:10 + 2 * i, 4:12, 4:12, i] += 3.0
    return torch.tensor(x, dtype=torch.float32)


def test_fourd_train_step_launches_no_backward_kernel(cuda):
    """A 4D train step on the card: K1-K4 once per block in the encoder's
    one call on B·T volumes, no backward kernel, no gradient on the frozen
    encoder; the logits against the CPU plain path (5e-2 of the largest)."""
    model, cpu = _fourd_pair(cuda)
    x = _fourd_seqs()
    fwd, bwd = _launches(FOURD_BF16), _launches(FOURD_BWD)
    logits = model(x.to(cuda), train=True, seed=5)
    logits.square().sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(FOURD_BF16), fwd)] == [2] * 4
    assert _launches(FOURD_BWD) == bwd
    assert all(p.grad is None for p in model.volume_encoder.parameters())
    assert model.projection_head.projection_head.weight.grad is not None
    with torch.no_grad():
        got, want = model(x.to(cuda)).cpu(), cpu(x)
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()


def test_fourd_encodings_equal_the_3d_forward(cuda):
    """encode_sequence on the card equals the 3D model's forward on the
    same B·T volumes, bit for bit."""
    from neurovit_tpu_torch.models import NeuroEncoder
    model, _ = _fourd_pair(cuda)
    model3d = NeuroEncoder(_fourd_config(TRAINING_DIM=3), device=cuda, seed=3)
    x = _fourd_seqs().to(cuda)
    b, t = x.shape[0], x.shape[-1]
    with torch.no_grad():
        flat = model3d(x.permute(0, 4, 1, 2, 3).reshape(b * t, 20, 20, 20))
    assert torch.equal(model.encode_sequence(x).reshape(b * t, -1), flat)


def test_fourd_head_f32_matches_cpu(cuda):
    """The temporal layer and projection at f32 on the card against the CPU
    plain path within 1e-3, with dropout (the same Philox bits)."""
    model, cpu = _fourd_pair(cuda, TRAINING_PRECISION="f32")
    enc = torch.randn(2, 7, 2, generator=torch.Generator().manual_seed(0))
    for train in (False, True):
        got = model.apply_features(enc.to(cuda), train=train, seed=11)
        want = cpu.apply_features(enc, train=train, seed=11)
        assert (got.detach().cpu() - want.detach()).abs().max() <= 1e-3


def test_fourd_int8_encoder_runs_the_int8_kernels(cuda):
    """The trainer's int8 copy of the encoder: K10-K13, never K1-K4; its
    features within 5e-2 relative error of the bf16 encoder's."""
    import copy
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    model, _ = _fourd_pair(cuda)
    q8 = quantize_blocks(copy.deepcopy(model.volume_encoder.vit3d))
    x = _fourd_seqs().to(cuda)
    fwd, i8 = _launches(FOURD_BF16), _launches(FOURD_INT8)
    got = model.encode_sequence(x, encoder=q8)
    torch.cuda.synchronize()
    assert _launches(FOURD_BF16) == fwd
    assert [a - b for a, b in zip(_launches(FOURD_INT8), i8)] == [2] * 4
    want = model.encode_sequence(x)
    assert float((got - want).norm() / want.norm()) < 5e-2


def test_fourd_resnet_encoder_launches_k14(cuda):
    """The ResNet-10 as the 4D encoder: one K14 per forward, no K15, the
    probabilities against the CPU plain path within 2e-2."""
    model, cpu = _fourd_pair(cuda, MODEL_VOLUME_ENCODER="resnet",
                             MODEL_RESNET_DEPTH=10)
    x = _fourd_seqs(1, 4)
    pool, pool_bwd = (maxpool3d.max_pool3d_argmax_cuda,
                      maxpool3d.max_pool3d_argmax_bwd_cuda)
    before = (pool.launches, pool_bwd.launches)
    got = torch.softmax(model(x.to(cuda), train=True, seed=1), -1)
    got.sum().backward()
    torch.cuda.synchronize()
    assert (pool.launches, pool_bwd.launches) == (before[0] + 1, before[1])
    with torch.no_grad():
        want = torch.softmax(cpu(x), -1)
    assert (got.detach().cpu() - want).abs().max() <= 2e-2


# K1-K4 at f32 (csrc/*_f32.cu): f32 products in 3xTF32 on the tensor
# cores, held to the plain versions at rtol = atol = 1e-4 (f32 sums taken
# in another order; the dropout masks are the same bits on both sides).
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _check_f32(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **F32_TOL)


def _f32(rng, shape, device, scale=1.0, offset=0.0):
    return _rand(rng, shape, device, torch.float32, scale, offset)


# (b, n, n_valid, heads, head dim): one token, ragged query and key tiles,
# n_valid inside the last key tile and off it, head dims on each instance
# (32, 64, 128) and padded to one (16, 80), the flagship at batch 8.
F32_ATTN_CASES = [(1, 1, 1, 2, 64), (2, 70, 70, 3, 64), (2, 130, 97, 2, 32),
                  (1, 1001, 900, 2, 128), (2, 65, 65, 4, 16),
                  (1, 100, 33, 2, 80), (8, 1001, 1001, 8, 64)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid,h,d", F32_ATTN_CASES)
def test_flash_attention_f32_kernel(cuda, b, n, n_valid, h, d, rate):
    """K1 at f32 with its row sums against plain, one launch a call, two
    calls bit-equal; the bf16 K1 not launched."""
    rng = np.random.default_rng(n + d)
    q, k, v = (_f32(rng, (b, n, h, d), cuda) for _ in range(3))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 5, "return_stats": True}
    before = (fa.flash_attention_f32_cuda.launches,
              fa.flash_attention_cuda.launches)
    got = fa.flash_attention(q, k, v, scale=kw["scale"], n_valid=n_valid,
                             dropout_rate=rate, seed=5)
    _check_f32(got, fa.flash_attention_plain(q, k, v, **dict(
        kw, return_stats=False)))
    assert (fa.flash_attention_f32_cuda.launches,
            fa.flash_attention_cuda.launches) == (before[0] + 1, before[1])
    o, lsum = fa.flash_attention_f32_cuda(q, k, v, **kw)
    _check_f32((o, lsum), fa.flash_attention_plain(q, k, v, **kw))
    again = fa.flash_attention_f32_cuda(q, k, v, **kw)
    assert torch.equal(o, again[0]) and torch.equal(lsum, again[1])


F32_QKV_CASES = [(1, 64, 4, 16), (65, 512, 4, 64), (130, 1024, 8, 64),
                 (300, 384, 6, 64), (130, 1280, 16, 80), (8008, 1024, 8, 64)]


@pytest.mark.parametrize("return_u", [False, True])
@pytest.mark.parametrize("m,dim,heads,dh", F32_QKV_CASES)
def test_fused_ln_qkv_f32_kernel(cuda, m, dim, heads, dh, return_u):
    """K2 at f32 (u too in training) against plain; u served from the
    scratch gives the q, k, v of u returned, bit for bit."""
    rng = np.random.default_rng(m + dim)
    args = (_f32(rng, (1, m, dim), cuda),
            _f32(rng, (dim,), cuda, 0.1, 1.0), _f32(rng, (dim,), cuda, 0.1),
            _f32(rng, (3 * heads * dh, dim), cuda, dim ** -0.5), heads, dh)
    got = fused_qkv.fused_ln_qkv_f32_cuda(*args, return_u=return_u)
    _check_f32(got, fused_qkv.fused_ln_qkv_plain(*args, return_u=return_u))
    other = fused_qkv.fused_ln_qkv_f32_cuda(*args, return_u=not return_u)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], other[:3]))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", [(1, 64, 64), (130, 1024, 512),
                                         (300, 768, 768), (8008, 1024, 512),
                                         (65, 1280, 1280)])
def test_fused_outproj_f32_kernel(cuda, m, dim, inner, rate):
    """K3 at f32 against plain, one launch a call after one launch of the
    forwards' weight pre-pass on Wout, two calls bit-equal."""
    from neurovit_tpu_torch.ops import tf32x3
    rng = np.random.default_rng(m + inner)
    args = (_f32(rng, (1, m, dim), cuda), _f32(rng, (1, m, inner), cuda),
            _f32(rng, (dim, inner), cuda, inner ** -0.5),
            _f32(rng, (dim,), cuda, 0.05))
    kw = {"dropout_rate": rate, "seed": 11}
    before = (fused_outproj.fused_outproj_residual_f32_cuda.launches,
              tf32x3.split_cuda.launches)
    got = fused_outproj.fused_outproj_residual(*args, **kw)
    _check_f32(got, fused_outproj.fused_outproj_residual_plain(*args, **kw))
    assert (fused_outproj.fused_outproj_residual_f32_cuda.launches,
            tf32x3.split_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, fused_outproj.fused_outproj_residual(*args, **kw))


def _mlp_f32_args(rng, m, dim, hid, device, zero_rows=(), zero_bias=False):
    x = _f32(rng, (1, m, dim), device)
    x[0, list(zero_rows)] = 0
    args = [x, _f32(rng, (dim,), device, 0.1, 1.0),
            _f32(rng, (dim,), device, 0.1),
            _f32(rng, (hid, dim), device, dim ** -0.5),
            _f32(rng, (hid,), device, 0.05),
            _f32(rng, (dim, hid), device, hid ** -0.5),
            _f32(rng, (dim,), device, 0.05)]
    if zero_bias:
        args[2].zero_()
        args[4].zero_()
    return tuple(args)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,hid", [(1, 64, 128), (33, 256, 384),
                                       (130, 1024, 2048), (300, 1280, 5120),
                                       (8008, 1024, 2048)])
def test_fused_mlp_f32_kernel(cuda, m, dim, hid, rate):
    """K4 at f32 with h (the pre-GELU hidden) against plain, and without
    h the same y; two calls bit-equal."""
    args = _mlp_f32_args(np.random.default_rng(m + hid), m, dim, hid, cuda)
    kw = {"dropout_rate": rate, "seeds": (8, 9)}
    got = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    _check_f32(got, fused_mlp.fused_mlp_block_plain(*args, return_h=True,
                                                    **kw))
    y = fused_mlp.fused_mlp_block_f32_cuda(*args, **kw)
    assert torch.equal(y, got[0])


@pytest.mark.parametrize("zero_bias", [True, False])
def test_f32_kernels_zero_rows(cuda, zero_bias):
    """All-zero rows at a tile's first and last row and in the ragged tile:
    with beta = b1 = 0, K4's h is 0 there and y is b2; K2's u is beta."""
    rows = (0, 127, 128, 129)
    args = _mlp_f32_args(np.random.default_rng(3), 130, 256, 384, cuda,
                         zero_rows=rows, zero_bias=zero_bias)
    y, h = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True)
    _check_f32((y, h), fused_mlp.fused_mlp_block_plain(*args, return_h=True))
    x, gamma, beta = args[:3]
    w = _f32(np.random.default_rng(4), (3 * 128, 256), cuda, 256 ** -0.5)
    qkvu = fused_qkv.fused_ln_qkv_f32_cuda(x, gamma, beta, w, 2, 64,
                                           return_u=True)
    _check_f32(qkvu, fused_qkv.fused_ln_qkv_plain(x, gamma, beta, w, 2, 64,
                                                  return_u=True))
    if zero_bias:
        assert torch.equal(y[0, list(rows)],
                           args[-1].expand(len(rows), -1))
        assert not h[0, list(rows)].abs().max()
        assert not qkvu[3][0, list(rows)].abs().max()


def test_f32_plans_match_the_kernels(cuda):
    """The wrappers' f32 plans count the 3xTF32 GEMMs' shared memory of
    K3, K4 and K2 (``nvt_fused_outproj_f32_smem_bytes``,
    ``nvt_fused_mlp_f32_smem_bytes``, ``nvt_fused_ln_qkv_f32_smem_bytes``),
    the weight pre-pass's blocks, K4's scratch and K1's shared memory (its
    Q box, TMA ring and barriers) as the kernels do, at every width and
    head-dim instance."""
    import ctypes

    from neurovit_tpu_torch.ops import _build, tf32x3
    lib = _build.library()
    scratch = lib.nvt_fused_mlp_f32_scratch_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    attn = lib.nvt_flash_attention_f32_smem_bytes
    attn.restype, attn.argtypes = ctypes.c_longlong, [ctypes.c_int]
    for entry in (lib.nvt_fused_outproj_f32_smem_bytes,
                  lib.nvt_fused_mlp_f32_smem_bytes,
                  lib.nvt_fused_ln_qkv_f32_smem_bytes):
        entry.restype, entry.argtypes = ctypes.c_longlong, []
        assert entry() == tf32x3.SMEM
    blocks = lib.nvt_split_f32_blocks
    blocks.restype, blocks.argtypes = ctypes.c_int, [ctypes.c_longlong]
    for dim, heads, dh, hid in WIDTHS.values():
        for m in (1, 130, 8008, 32032):
            plan = fused_mlp.mlp_f32_plan(m, dim, hid)
            assert scratch(m, dim, hid) == plan.scratch_bytes
            assert [launch[3] for launch in plan.launches[3:]] == [
                lib.nvt_fused_mlp_f32_smem_bytes()] * 2
            qkv = fused_qkv.qkv_f32_plan(m, dim, heads * dh).launches
            assert qkv[-1][3] == lib.nvt_fused_ln_qkv_f32_smem_bytes()
            out = fused_outproj.outproj_f32_plan(m, dim, heads * dh).launches
            assert out[-1][3] == lib.nvt_fused_outproj_f32_smem_bytes()
        for n, launch in ((hid * dim, plan.launches[0]),
                          (3 * heads * dh * dim, qkv[0]),
                          (dim * heads * dh, out[0])):
            assert launch[1] == (blocks(n), 1)
        plan = fa.flash_f32_plan(2, 1001, heads, dh)
        assert attn(plan.d_kernel) == plan.smem
    for dh in (16, 32, 64, 128):
        plan = fa.flash_f32_plan(2, 1001, 2, dh)
        assert attn(plan.d_kernel) == plan.smem


def test_f32_kernels_do_not_spill(cuda):
    """ptxas's report in the build log: no kernel of the f32 forwards and
    backwards (csrc/*_f32.cu, the row passes of csrc/ffma.cu) spills, K8
    f32's weight pre-pass and 3xTF32 wgmma GEMM, K4 f32's fc1 and fc2 (fc2
    also K3 f32's one GEMM: fused_outproj_f32.cu compiles no GEMM of its
    own) and K2 f32's QKV GEMM on the same Loop, K9 f32's hidden GEMM and the du
    GEMM of K9 and K7 at f32 (tf32x3_ln_bwd.cuh, an instance in each
    source), the forwards' weight pre-pass and
    the six 3xTF32 instances of K1 and K6 at f32 among them, nor any f32
    instance in csrc/int8_*.cu (the int8 serving kernels' passes on the
    element type float, which their templates take first: names
    "<kernel>If...")."""
    from neurovit_tpu_torch.ops import _build
    kernels, _ = _build.ptxas_report(
        _build.build_log(_build.build()).read_text())
    int8_f32 = [k for k in kernels if k[0].startswith("int8_")
                and not k[0].endswith("_f32.cu") and "_kernelIf" in k[1]]
    f32 = [k for k in kernels
           if k[0].endswith("_f32.cu") or k[0] == "ffma.cu"] + int8_f32
    assert len(f32) >= 37 and len(int8_f32) >= 10
    k8 = [k[1] for k in f32 if k[0] == "fused_outproj_bwd_f32.cu"]
    assert any("dattn_kernel" in k for k in k8)
    assert any("split_t_kernel" in k for k in k8)
    # K4 and K2 at f32: the 3xTF32 GEMMs and the forwards' pre-pass.
    k4 = [k[1] for k in f32 if k[0] == "fused_mlp_f32.cu"]
    for name in ("fc1_gelu_kernel", "fc2_residual_kernel", "split_kernel"):
        assert any(name in k for k in k4), name
    # K3 at f32: its source holds only the instances of the header's
    # pre-passes that every source including tf32x3_wgmma.cuh compiles.
    k3 = [k[1] for k in f32 if k[0] == "fused_outproj_f32.cu"]
    assert k3 and all("split_kernel" in k or "split_t_kernel" in k
                      for k in k3), k3
    assert any("qkv_gemm_kernel" in k[1] for k in f32
               if k[0] == "fused_qkv_f32.cu")
    # K9 and K7 at f32: the 3xTF32 hidden and du GEMMs.
    k9 = [k[1] for k in f32 if k[0] == "fused_mlp_bwd_f32.cu"]
    for name in ("hidden_kernel", "ln_du_kernel"):
        assert any(name in k for k in k9), name
    assert any("ln_du_kernel" in k[1] for k in f32
               if k[0] == "fused_qkv_bwd_f32.cu")
    # K1 and K6 at f32: D 32, 64 and 128 in both layouts.
    fwd = [k[1] for k in f32 if k[0] == "flash_attention_f32.cu"]
    assert len(fwd) == 6 and all("flash_fwd_f32_kernel" in k for k in fwd)
    assert [k[:2] for k in f32 if k[3] or k[4]] == []


def test_f32_forward_runs_the_f32_kernels(cuda):
    """An f32 ViT's forward on the card launches K1-K4 at f32 once a block
    and no bf16 kernel, its logits within 1e-4 of the CPU plain path; a
    bf16 forward of the same weights launches no f32 kernel."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder

    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "MODEL_VIT_DIM": 256, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 64, "MODEL_VIT_MLP_DIM": 512})
    f32 = (fa.flash_attention_f32_cuda, fused_qkv.fused_ln_qkv_f32_cuda,
           fused_outproj.fused_outproj_residual_f32_cuda,
           fused_mlp.fused_mlp_block_f32_cuda)
    bf16 = (fa.flash_attention_cuda, fused_qkv.fused_ln_qkv_cuda,
            fused_outproj.fused_outproj_residual_cuda,
            fused_mlp.fused_mlp_block_cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 20, 20, 20)).astype(np.float32))
    cpu = NeuroEncoder(config, device="cpu", seed=3)
    model = NeuroEncoder(config, device=cuda, seed=3)
    before = [fn.launches for fn in f32 + bf16]
    with torch.no_grad():
        got = model(x.to(cuda))
        want = cpu(x)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(f32 + bf16, before)] == \
        [2] * 4 + [0] * 4
    torch.testing.assert_close(got.cpu(), want, **F32_TOL)
    model16 = NeuroEncoder(dict(config, TRAINING_PRECISION="bf16"),
                           device=cuda, seed=3)
    before = [fn.launches for fn in f32]
    with torch.no_grad():
        model16(x.to(cuda))
    assert [fn.launches for fn in f32] == before


# The f32 backwards K5, K7, K8 and K9 (csrc/*_bwd_f32.cu): data gradients
# at F32_TOL, dgamma and dbeta by relative Frobenius error (f32 sums over
# the rows in another order).
F32_PARAM_RTOL = 1e-5


def _check_f32_bwd(got, want, params=()):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.float32
        assert g.reshape(w.shape).shape == w.shape
        g = g.reshape(w.shape)
        assert torch.isfinite(g).all()
        if i in params:
            assert float((g - w).norm()) <= F32_PARAM_RTOL * float(w.norm())
        else:
            torch.testing.assert_close(g, w, **F32_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid,h,d", F32_ATTN_CASES)
def test_flash_attention_bwd_f32_kernel(cuda, b, n, n_valid, h, d, rate):
    """K5 at f32 against plain on the forward's o and row sums, one launch
    a call and no bf16 K5, two calls bit-equal."""
    rng = np.random.default_rng(n + d + 1)
    q, k, v, do = (_f32(rng, (b, n, h, d), cuda) for _ in range(4))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 7}
    o, lsum = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
    before = (fa.flash_attention_bwd_f32_cuda.launches,
              fa.flash_attention_bwd_cuda.launches)
    got = fa.flash_attention_bwd_f32_cuda(q, k, v, o, do, lsum, **kw)
    assert (fa.flash_attention_bwd_f32_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1])
    _check_f32_bwd(got, fa.flash_attention_bwd_plain(q, k, v, o, do, lsum,
                                                     **kw))
    again = fa.flash_attention_bwd_f32_cuda(q, k, v, o, do, lsum, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    if n_valid < n:
        assert not got[1][:, n_valid:].abs().max()
        assert not got[2][:, n_valid:].abs().max()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,inner", [(1, 64, 64), (130, 1024, 512),
                                         (300, 768, 768), (8008, 1024, 512),
                                         (65, 1280, 1280), (33, 1536, 1040),
                                         (520, 64, 64), (130, 384, 384),
                                         (130, 1024, 1024), (129, 48, 16)])
def test_fused_outproj_bwd_f32_kernel(cuda, m, dim, inner, rate):
    """K8 at f32 (3xTF32 on wgmma): (dattn, dz) against plain at the
    flagship block, 130 rows, the 2D tutorial's 64 / 64, ViT-S/B/L widths
    and ragged ones, dz dy itself at dropout 0, two calls bit-equal."""
    rng = np.random.default_rng(m + inner + 2)
    dy = _f32(rng, (1, m, dim), cuda)
    w = _f32(rng, (dim, inner), cuda, inner ** -0.5)
    kw = {"dropout_rate": rate, "seed": 12}
    got = fused_outproj.fused_outproj_bwd_f32_cuda(dy, w, **kw)
    _check_f32_bwd(got, fused_outproj.fused_outproj_bwd_plain(dy, w, **kw))
    if not rate:
        assert got[1] is dy
    again = fused_outproj.fused_outproj_bwd_f32_cuda(dy, w, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_outproj_bwd_f32_tf32x3_accuracy(cuda, rate):
    """K8 at f32 at the flagship block (8008 rows, dim 1024, inner 512):
    dattn's relative Frobenius error against plain below 1e-5
    (chip_smoke.py's F32_CAM_RTOL), all-zero rows of dy give dattn = 0
    there, and each call launches the weight pre-pass once and K8 once,
    the pre-pass bit-equal to its plain version."""
    from neurovit_tpu_torch.ops import tf32x3
    rng = np.random.default_rng(28)
    dy = _f32(rng, (8, 1001, 1024), cuda)
    w = _f32(rng, (1024, 512), cuda, 512 ** -0.5)
    zero = [0, 127, 128, 1000]
    dy[0, zero] = 0
    kw = {"dropout_rate": rate, "seed": 5}
    before = (tf32x3.split_t_cuda.launches,
              fused_outproj.fused_outproj_bwd_f32_cuda.launches)
    got, _ = fused_outproj.fused_outproj_bwd_f32_cuda(dy, w, **kw)
    assert (tf32x3.split_t_cuda.launches,
            fused_outproj.fused_outproj_bwd_f32_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want, _ = fused_outproj.fused_outproj_bwd_plain(dy, w, **kw)
    torch.cuda.synchronize()
    assert float((got - want).norm()) < 1e-5 * float(want.norm())
    assert not got[0, zero].abs().max()
    for g, p in zip(tf32x3.split_t_cuda(w), tf32x3.split_t_plain(w)):
        assert torch.equal(g, p)


# The widths of K4 f32 and K2 f32 in 3xTF32: WIDTHS, ViT-H and the 2D
# tutorial's (dim 64, 4 heads of 16, MLP 128) at its 197 tokens.
TF32X3_FWD_WIDTHS = sorted(WIDTHS.items()) + [
    ("vit_h", (1280, 16, 80, 5120)), ("tutorial_2d", (64, 4, 16, 128))]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("width,shape", TF32X3_FWD_WIDTHS)
def test_mlp_qkv_f32_tf32x3_widths(cuda, width, shape, rate):
    """K4 f32 (with h) and K2 f32 (with u) in 3xTF32 on wgmma against
    plain within F32_TOL at every width, at 1001 rows (197 for the 2D
    tutorial), K4 at dropout 0 and 0.1; the weight pre-pass launched once
    a weight (W1 and W2, Wqkv), two calls bit-equal."""
    from neurovit_tpu_torch.ops import tf32x3
    dim, heads, dh, hid = shape
    m = 197 if width == "tutorial_2d" else 1001
    args = _mlp_f32_args(np.random.default_rng(dim + hid), m, dim, hid, cuda)
    kw = {"dropout_rate": rate, "seeds": (21, 22)}
    before = tf32x3.split_cuda.launches
    got = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    assert tf32x3.split_cuda.launches == before + 2
    _check_f32(got, fused_mlp.fused_mlp_block_plain(*args, return_h=True,
                                                    **kw))
    again = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rng = np.random.default_rng(dim + dh)
    qargs = (args[0], args[1], args[2],
             _f32(rng, (3 * heads * dh, dim), cuda, dim ** -0.5), heads, dh)
    before = tf32x3.split_cuda.launches
    got = fused_qkv.fused_ln_qkv_f32_cuda(*qargs, return_u=True)
    assert tf32x3.split_cuda.launches == before + 1
    _check_f32(got, fused_qkv.fused_ln_qkv_plain(*qargs, return_u=True))
    again = fused_qkv.fused_ln_qkv_f32_cuda(*qargs, return_u=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_qkv_f32_tf32x3_accuracy(cuda, rate):
    """K4 f32 and K2 f32 at the flagship block (8008 rows, dim 1024, 8
    heads of 64, MLP 2048): y, h, q, k and v within 1e-5 relative
    Frobenius error of plain (chip_smoke.py's F32_CAM_RTOL)."""
    rng = np.random.default_rng(30)
    args = _mlp_f32_args(rng, 8008, 1024, 2048, cuda)
    kw = {"dropout_rate": rate, "seeds": (5, 6)}
    got = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    want = fused_mlp.fused_mlp_block_plain(*args, return_h=True, **kw)
    w = _f32(rng, (1536, 1024), cuda, 1024 ** -0.5)
    got += fused_qkv.fused_ln_qkv_f32_cuda(*args[:3], w, 8, 64)
    want += fused_qkv.fused_ln_qkv_plain(*args[:3], w, 8, 64)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert float((g - p).norm()) < 1e-5 * float(p.norm())


@pytest.mark.parametrize("shape,scale", [((2048, 1024), 1.0),
                                         ((1024, 2048), 1e3),
                                         ((1536, 1024), 1e-30),
                                         ((5120, 1280), 1.0),
                                         ((192, 64), 1.0), ((16, 16), 1.0),
                                         ((3, 4), 1.0)])
def test_split_f32_is_plain_bit_for_bit(cuda, shape, scale):
    """The forwards' weight pre-pass (a grid-stride walk of at most 1056
    blocks: W1 and W2 of the flagship take two turns) equals split_plain
    bit for bit, and counts one launch a call."""
    from neurovit_tpu_torch.ops import tf32x3
    w = _f32(np.random.default_rng(shape[0]), shape, cuda, scale)
    before = tf32x3.split_cuda.launches
    got = tf32x3.split_cuda(w)
    assert tf32x3.split_cuda.launches == before + 1
    for g, p in zip(got, tf32x3.split_plain(w)):
        assert g.shape == w.shape and torch.equal(g, p)


def test_outproj_bwd_f32_plan_smem_is_the_kernels(cuda):
    """K8 f32's plan asks for the dattn GEMM's shared memory as the kernel
    counts it (``nvt_fused_outproj_f32_bwd_smem_bytes``)."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    fn = _build.library().nvt_fused_outproj_f32_bwd_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, []
    for m, dim, inner in ((1, 64, 64), (8008, 1024, 512), (130, 1536, 1040)):
        for rate in (0.0, 0.1):
            dattn = fused_outproj.outproj_bwd_f32_plan(m, dim, inner,
                                                       rate).launches[-1]
            assert dattn[0] == "dattn" and dattn[3] == fn()


@pytest.mark.parametrize("m,dim,heads,dh", F32_QKV_CASES)
def test_fused_ln_qkv_bwd_f32_kernel(cuda, m, dim, heads, dh):
    """K7 at f32: dx against plain, dgamma and dbeta by relative Frobenius
    error, two calls bit-equal; all-zero rows of dqkv give dx 0 there;
    each call launches the weight pre-pass once."""
    from neurovit_tpu_torch.ops import tf32x3
    rng = np.random.default_rng(m + dim + 3)
    inner = heads * dh
    dqkv = _f32(rng, (1, m, 3 * inner), cuda)
    dqkv[0, [0, m - 1]] = 0
    args = (dqkv, _f32(rng, (1, m, dim), cuda),
            _f32(rng, (dim,), cuda, 0.1, 1.0),
            _f32(rng, (3 * inner, dim), cuda, dim ** -0.5))
    before = tf32x3.split_t_cuda.launches
    got = fused_qkv.fused_ln_qkv_bwd_f32_cuda(*args)
    assert tf32x3.split_t_cuda.launches == before + 1
    _check_f32_bwd(got, fused_qkv.fused_ln_qkv_bwd_plain(*args), (1, 2))
    assert not got[0][0, [0, m - 1]].abs().max()
    again = fused_qkv.fused_ln_qkv_bwd_f32_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,dim,hid", [(1, 64, 128), (33, 256, 384),
                                       (130, 1024, 2048), (300, 1280, 5120),
                                       (8008, 1024, 2048)])
def test_fused_mlp_bwd_f32_kernel(cuda, m, dim, hid, rate):
    """K9 at f32 on K4 f32's own h: (dx, u, a, dz, dh) against plain,
    dgamma and dbeta by relative Frobenius error; an all-zero row of dy
    gives dz = dh = dx = 0 there; u bit-equal to the u that K4 f32's
    LayerNorm pass computes (K2 f32 returns it); two calls bit-equal; each
    call launches the weight pre-pass twice (W2, W1)."""
    from neurovit_tpu_torch.ops import tf32x3
    args = _mlp_f32_args(np.random.default_rng(m + hid + 4), m, dim, hid,
                         cuda)
    x, gamma, beta, w1, b1, w2, b2 = args
    kw = {"dropout_rate": rate, "seeds": (21, 22)}
    _, h = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    dy = _f32(np.random.default_rng(m), (1, m, dim), cuda)
    dy[0, 0] = 0
    bargs = (dy, x, h, gamma, beta, w1, w2)
    before = tf32x3.split_t_cuda.launches
    got = fused_mlp.fused_mlp_bwd_f32_cuda(*bargs, **kw)
    assert tf32x3.split_t_cuda.launches == before + 2
    _check_f32_bwd(got, fused_mlp.fused_mlp_bwd_plain(*bargs, **kw), (5, 6))
    for j in (0, 3, 4):
        assert not got[j].reshape(m, -1)[0].abs().max()
    u = fused_qkv.fused_ln_qkv_f32_cuda(
        x, gamma, beta, torch.zeros(48, dim, device=cuda), 1, 16,
        return_u=True)[3]
    assert torch.equal(got[1], u.reshape(m, dim))
    if not rate:
        assert torch.equal(got[3], dy.reshape(m, dim))
    again = fused_mlp.fused_mlp_bwd_f32_cuda(*bargs, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_qkv_bwd_f32_tf32x3_accuracy(cuda, rate):
    """K9 f32 and K7 f32 at the flagship block (8008 rows, dim 1024, 8
    heads of 64, MLP 2048): dx, a and dh (K9), dx (K7) within 1e-5
    relative Frobenius error of plain (chip_smoke.py's F32_CAM_RTOL); the
    backwards' weight pre-pass bit-equal to its plain version on W2, W1
    and Wqkv."""
    from neurovit_tpu_torch.ops import tf32x3
    rng = np.random.default_rng(32)
    args = _mlp_f32_args(rng, 8008, 1024, 2048, cuda)
    x, gamma, beta, w1, b1, w2, b2 = args
    kw = {"dropout_rate": rate, "seeds": (7, 8)}
    _, h = fused_mlp.fused_mlp_block_f32_cuda(*args, return_h=True, **kw)
    dy = _f32(rng, (1, 8008, 1024), cuda)
    bargs = (dy, x, h, gamma, beta, w1, w2)
    got = fused_mlp.fused_mlp_bwd_f32_cuda(*bargs, **kw)
    want = fused_mlp.fused_mlp_bwd_plain(*bargs, **kw)
    pairs = [(got[j], want[j]) for j in (0, 2, 4)]
    wqkv = _f32(rng, (1536, 1024), cuda, 1024 ** -0.5)
    qargs = (_f32(rng, (1, 8008, 1536), cuda), x, gamma, wqkv)
    pairs.append((fused_qkv.fused_ln_qkv_bwd_f32_cuda(*qargs)[0],
                  fused_qkv.fused_ln_qkv_bwd_plain(*qargs)[0]))
    torch.cuda.synchronize()
    for g, p in pairs:
        assert float((g.reshape(p.shape) - p).norm()) < 1e-5 * float(
            p.norm())
    for w in (w2, w1, wqkv):
        for g, p in zip(tf32x3.split_t_cuda(w), tf32x3.split_t_plain(w)):
            assert torch.equal(g, p)


def test_f32_bwd_plans_match_the_kernels(cuda):
    """The wrappers' f32 backward plans count the scratch of K7 and K9,
    the shared memory of their 3xTF32 GEMMs
    (``nvt_fused_mlp_f32_bwd_smem_bytes``,
    ``nvt_fused_ln_qkv_f32_bwd_smem_bytes``) and K5's as the kernels do."""
    import ctypes

    from neurovit_tpu_torch.ops import _build, tf32x3
    lib = _build.library()
    scratch = lib.nvt_ln_bwd_f32_scratch_bytes
    scratch.restype, scratch.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    attn = lib.nvt_flash_attention_f32_bwd_smem_bytes
    attn.restype, attn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    smem = {}
    for name in ("nvt_fused_mlp_f32_bwd_smem_bytes",
                 "nvt_fused_ln_qkv_f32_bwd_smem_bytes"):
        entry = getattr(lib, name)
        entry.restype, entry.argtypes = ctypes.c_longlong, []
        smem[name] = entry()
        assert smem[name] == tf32x3.SMEM
    for dim, heads, dh, hid in WIDTHS.values():
        for m in (1, 130, 8008, 32032):
            want = scratch(m, dim)
            mlp = fused_mlp.mlp_bwd_f32_plan(m, dim, hid)
            qkv = fused_qkv.qkv_bwd_f32_plan(m, dim, heads * dh)
            assert want == mlp.scratch_bytes == qkv.scratch_bytes
            assert [launch[3] for launch in mlp.launches
                    if launch[0] in ("hidden", "du")] == [
                smem["nvt_fused_mlp_f32_bwd_smem_bytes"]] * 2
            assert [launch[3] for launch in qkv.launches
                    if launch[0] == "du"] == [
                smem["nvt_fused_ln_qkv_f32_bwd_smem_bytes"]]
        plan = fa.flash_f32_bwd_plan(2, 1001, heads, dh)
        assert attn(plan.d_kernel, 1) == plan.dq_smem
        assert attn(plan.d_kernel, 2) == plan.dkv_smem


def test_f32_train_step_runs_the_f32_kernels(cuda):
    """An f32 ViT's train step on the card (loss.backward through the
    model) launches K1-K5 and K7-K9 at f32 once a block and no bf16 block
    kernel; its loss and every parameter gradient within 1e-4 relative
    Frobenius error of the CPU plain path's, at dropout 0.1."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder

    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "MODEL_VIT_DIM": 256, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 64, "MODEL_VIT_MLP_DIM": 512})
    f32 = (fa.flash_attention_f32_cuda, fused_qkv.fused_ln_qkv_f32_cuda,
           fused_outproj.fused_outproj_residual_f32_cuda,
           fused_mlp.fused_mlp_block_f32_cuda,
           fa.flash_attention_bwd_f32_cuda,
           fused_qkv.fused_ln_qkv_bwd_f32_cuda,
           fused_outproj.fused_outproj_bwd_f32_cuda,
           fused_mlp.fused_mlp_bwd_f32_cuda)
    bf16 = (fa.flash_attention_cuda, fused_qkv.fused_ln_qkv_cuda,
            fused_outproj.fused_outproj_residual_cuda,
            fused_mlp.fused_mlp_block_cuda, fa.flash_attention_bwd_cuda,
            fused_qkv.fused_ln_qkv_bwd_cuda, fused_outproj.fused_outproj_bwd_cuda,
            fused_mlp.fused_mlp_bwd_cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 20, 20, 20)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 2)).astype(np.float32))
    grads, losses = {}, {}
    for device in ("cpu", cuda):
        model = NeuroEncoder(config, device=device, seed=4).train()
        before = [fn.launches for fn in f32 + bf16]
        with nn.full_f32(torch.float32):
            loss = (model(x.to(device), train=True, seed=9)
                    * w.to(device)).sum()
            loss.backward()
        torch.cuda.synchronize()
        if device == cuda:
            assert [fn.launches - b for fn, b in zip(f32 + bf16, before)] \
                == [2] * 8 + [0] * 8
        losses[str(device)] = float(loss.detach())
        grads[str(device)] = {n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()
                              if p.grad is not None}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * (
        1 + abs(losses["cpu"]))
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert float((got - want).norm() / want.norm().clamp_min(1e-30)) \
            <= 1e-4, name


# K6 and its backward at f32 (the bhnd instances of
# csrc/flash_attention_f32.cu and csrc/flash_attention_bwd_f32.cu), at
# chip_smoke.py's shapes: the flagship probe's block, n_valid 900, and head
# dims 16 (padded to 32), 32, 64 and 128 on the 2D tutorial's 197 tokens.
K6_F32_CASES = [(8, 1001, 1001, 8, 64), (2, 1001, 900, 2, 64),
                (2, 197, 197, 2, 16), (2, 197, 197, 2, 32),
                (2, 197, 197, 2, 64), (2, 197, 197, 2, 128)]


def _bnhd(t):
    return t.transpose(1, 2).contiguous()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid,h,d", K6_F32_CASES)
def test_flash_attention_bhnd_f32_kernel(cuda, b, n, n_valid, h, d, rate):
    """K6 at f32 with its row sums against plain, one launch a call and
    no other attention kernel, two calls bit-equal, and bit-equal to K1 at
    f32 on the same heads in [B, N, H, D] (one kernel, two layouts)."""
    rng = np.random.default_rng(n + d + 3)
    q, k, v = (_f32(rng, (b, h, n, d), cuda) for _ in range(3))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 5, "return_stats": True}
    counted = (fa.flash_attention_bhnd_f32_cuda, fa.flash_attention_bhnd_cuda,
               fa.flash_attention_f32_cuda)
    before = [fn.launches for fn in counted]
    got = fa.flash_attention(q, k, v, scale=kw["scale"], n_valid=n_valid,
                             dropout_rate=rate, seed=5, layout="bhnd")
    _check_f32(got, fa.flash_attention_bhnd_plain(q, k, v, **dict(
        kw, return_stats=False)))
    assert [fn.launches - b_ for fn, b_ in zip(counted, before)] == [1, 0, 0]
    o, lsum = fa.flash_attention_bhnd_f32_cuda(q, k, v, **kw)
    _check_f32((o, lsum), fa.flash_attention_bhnd_plain(q, k, v, **kw))
    again = fa.flash_attention_bhnd_f32_cuda(q, k, v, **kw)
    assert torch.equal(o, again[0]) and torch.equal(lsum, again[1])
    o1, lsum1 = fa.flash_attention_f32_cuda(_bnhd(q), _bnhd(k), _bnhd(v),
                                            **kw)
    assert torch.equal(_bnhd(o1), o) and torch.equal(lsum1, lsum)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_f32_tf32x3_accuracy(cuda, rate, layout):
    """K1 and K6 at f32 in 3xTF32 at the flagship block (batch 8 x 1001
    tokens, 8 heads of 64): o's relative Frobenius error against plain,
    printed, below 1e-5 (chip_smoke.py's F32_CAM_RTOL), and the row sums
    within F32_TOL; one launch of the layout's wrapper a call."""
    rng = np.random.default_rng(29)
    shape = (8, 1001, 8, 64) if layout == "bnhd" else (8, 8, 1001, 64)
    q, k, v = (_f32(rng, shape, cuda) for _ in range(3))
    kw = {"scale": 0.125, "n_valid": 1001, "dropout_rate": rate, "seed": 9,
          "return_stats": True}
    kernel, plain = ((fa.flash_attention_f32_cuda, fa.flash_attention_plain)
                     if layout == "bnhd" else
                     (fa.flash_attention_bhnd_f32_cuda,
                      fa.flash_attention_bhnd_plain))
    before = kernel.launches
    o, lsum = kernel(q, k, v, **kw)
    assert kernel.launches == before + 1
    want, want_l = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    rel = float((o - want).norm() / want.norm())
    print(f"\nK1/K6 f32 {layout} dropout {rate}: o's relative Frobenius "
          f"error {rel:.3e}")
    assert rel < 1e-5
    _check_f32(lsum, want_l)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,n_valid,h,d", K6_F32_CASES)
def test_flash_attention_bhnd_bwd_f32_kernel(cuda, b, n, n_valid, h, d,
                                             rate):
    """K6's backward at f32 against plain on the forward's o and row sums,
    one launch a call and no other attention backward, two calls
    bit-equal, bit-equal to K5 at f32 in [B, N, H, D], and no gradient for
    keys at or past n_valid."""
    rng = np.random.default_rng(n + d + 4)
    q, k, v, do = (_f32(rng, (b, h, n, d), cuda) for _ in range(4))
    kw = {"scale": d ** -0.5, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 7}
    o, lsum = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True, **kw)
    counted = (fa.flash_attention_bhnd_bwd_f32_cuda,
               fa.flash_attention_bhnd_bwd_cuda,
               fa.flash_attention_bwd_f32_cuda)
    before = [fn.launches for fn in counted]
    got = fa.flash_attention_bhnd_bwd_f32_cuda(q, k, v, o, do, lsum, **kw)
    assert [fn.launches - b_ for fn, b_ in zip(counted, before)] == [1, 0, 0]
    _check_f32_bwd(got, fa.flash_attention_bhnd_bwd_plain(q, k, v, o, do,
                                                          lsum, **kw))
    again = fa.flash_attention_bhnd_bwd_f32_cuda(q, k, v, o, do, lsum, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    bnhd = fa.flash_attention_bwd_f32_cuda(
        *(_bnhd(t) for t in (q, k, v, o, do)), lsum, **kw)
    assert all(torch.equal(_bnhd(a), g) for a, g in zip(bnhd, got))
    if n_valid < n:
        assert not got[1][:, :, n_valid:].abs().max()
        assert not got[2][:, :, n_valid:].abs().max()


def test_f32_probe_runs_k6_f32(cuda):
    """An f32 ViT's probe forward and backward on the card: one K6 f32
    forward and one backward, K1-K3 f32 once for block 0, K4 f32 once a
    block, K9 f32 once (the last block's MLP under the gradient), no bf16
    kernel; the logits, the probe's activations and gradients and the raw
    CAM within 1e-4 of their largest magnitude of the CPU plain path's, and
    the classes equal. The LayerNorm affines are moved off their init (at
    ones and zeros the raw CAM is rounding noise, as
    tests/test_torch_gradcam.py says)."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.explainability import gradcam_vit3d as gc
    from neurovit_tpu_torch.models import NeuroEncoder

    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "MODEL_VIT_DIM": 256, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 64, "MODEL_VIT_MLP_DIM": 512})
    f32 = (fa.flash_attention_bhnd_f32_cuda,
           fa.flash_attention_bhnd_bwd_f32_cuda, fa.flash_attention_f32_cuda,
           fused_qkv.fused_ln_qkv_f32_cuda,
           fused_outproj.fused_outproj_residual_f32_cuda,
           fused_mlp.fused_mlp_block_f32_cuda,
           fused_mlp.fused_mlp_bwd_f32_cuda)
    bf16 = (fa.flash_attention_bhnd_cuda, fa.flash_attention_bhnd_bwd_cuda,
            fa.flash_attention_cuda, fused_mlp.fused_mlp_block_cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 20, 20, 20)).astype(np.float32))
    cpu = NeuroEncoder(config, device="cpu", seed=4)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for module in cpu.modules():
            if isinstance(module, torch.nn.LayerNorm):
                module.weight.add_(torch.from_numpy(0.3 * rng.standard_normal(
                    tuple(module.weight.shape)).astype(np.float32)))
                module.bias.add_(torch.from_numpy(0.3 * rng.standard_normal(
                    tuple(module.bias.shape)).astype(np.float32)))
    out = {}
    for device in ("cpu", cuda):
        model = NeuroEncoder(config, device=device, seed=4)
        model.load_state_dict(cpu.state_dict())
        before = [fn.launches for fn in f32 + bf16]
        logits, idx, acts, grads = gc.probe_acts_grads(model, x.to(device))
        torch.cuda.synchronize()
        if device == cuda:
            assert [fn.launches - b for fn, b in zip(f32 + bf16, before)] \
                == [1] * 5 + [2, 1] + [0] * 4
        raw = gc.raw_attention_map(model, acts, grads)
        out[str(device)] = [t.detach().cpu() for t in
                            (idx, logits, acts, grads, raw)]
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


# K10-K13 at f32 (the int8 serving of an f32 ViT): the f32 instances of
# csrc/int8_{rowquant,qkv,outproj,mlp}.cu and csrc/int8_attention_f32.cu.
# Their int32 products are exact on both sides; an f32 LayerNorm or GELU
# taken in another order can move a code by one step, and one step of one
# of a row's codes moves the row's outputs by up to about 1e-2 (the change
# passes through a whole GEMM). So the codes the kernels leave in a scratch
# kept here are read back: each differs from plain's by one step at most
# and in at most 1e-3 of the positions; the outputs equal plain's
# arithmetic on the kernel's own codes and row scales bit for bit; and the
# rows whose codes are all plain's own are within F32_TOL, 1e-4 (1 +
# |plain|). K11 at f32 rounds where plain does and is held bit for bit;
# K13 at f32 is held as chip_smoke.py's hold_int8_attn_f32 holds it.
INT8_F32_QKV_CASES = [(1, 512, 4, 64), (130, 1024, 8, 64),
                      (8008, 1024, 8, 64), (300, 1280, 16, 80),
                      (65, 384, 6, 64)]
INT8_F32_MLP_CASES = [(1, 64, 128), (130, 1024, 2048), (8008, 1024, 2048),
                      (65, 336, 1360)]


def _chip_smoke():
    """chip_smoke.py, loaded by path, for its f32 bounds."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _int8_f32_scratch(fn, args, plan):
    """Call the f32 int8 wrapper ``fn`` on ``args`` with a scratch kept
    here. Returns (its outputs, piece(name, dtype, columns): that piece of
    the scratch as [rows, columns])."""
    scratch = torch.zeros(plan.scratch_bytes, dtype=torch.uint8,
                          device="cuda")
    out = fn(*args, scratch=scratch)
    torch.cuda.synchronize()

    def piece(name, dtype, columns):
        at, nbytes = plan.scratch[name]
        return scratch[at:at + nbytes].view(dtype).reshape(-1, columns)
    return out, piece


def _code_flips(got, want):
    """The rows where the kernel's codes differ from plain's, each by one
    step at most, in at most 1e-3 of the positions (at least one)."""
    diff = (got.long() - want.reshape(got.shape).long()).abs()
    assert int(diff.max()) <= 1, int(diff.max())
    assert int(diff.sum()) <= max(1, diff.numel() // 1000), int(diff.sum())
    return diff.any(dim=1)


def _check_rows(got, want, rows):
    """F32_TOL, 1e-4 (1 + |plain|), on the rows (of [1, m, ...] outputs)
    where ``rows`` is False."""
    keep = ~rows
    for g, w in zip(got, want):
        torch.testing.assert_close(g[0, keep], w[0, keep], **F32_TOL)


@pytest.mark.parametrize("m,dim,heads,dh", INT8_F32_QKV_CASES)
def test_int8_ln_qkv_f32_kernel(cuda, m, dim, heads, dh):
    """K10 at f32: f32 q, k and v, one launch a call, two calls bit-equal,
    the bf16 K10 not launched; its codes u8 plain's but for one-step
    flips, q, k and v plain's products of them bit for bit, and plain's
    within F32_TOL on the rows without a flip."""
    rng = np.random.default_rng(m + dim + heads * dh + 1)
    x, gamma, beta, w8, s, _, _ = _int8_qkv_args(rng, m, dim, heads, dh,
                                                  cuda)
    x, inner = x.float(), heads * dh
    args = (x, gamma, beta, w8, s, heads, dh)
    before = (int8_serving.int8_ln_qkv_f32_cuda.launches,
              int8_serving.int8_ln_qkv_cuda.launches)
    got = int8_serving.int8_ln_qkv(*args)
    again = int8_serving.int8_ln_qkv(*args)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (int8_serving.int8_ln_qkv_f32_cuda.launches,
            int8_serving.int8_ln_qkv_cuda.launches) == (before[0] + 2,
                                                        before[1])
    outs, piece = _int8_f32_scratch(int8_serving.int8_ln_qkv_f32_cuda, args,
                                    int8_serving.qkv_plan(m, dim, inner))
    u8, s_row = piece("u8", torch.int8, dim), piece("s_row", torch.float32, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, outs))
    with nn.full_f32(torch.float32):
        codes, _ = int8_serving._rowquant(int8_serving._ln(x, gamma, beta))
        flipped = _code_flips(u8, codes)
        mine = int8_serving._deq_dot(u8.float(), s_row, w8, s).reshape(
            1, m, 3, heads, dh)
        want = int8_serving.int8_ln_qkv_plain(*args)
    assert all(torch.equal(got[i], mine[:, :, i]) for i in range(3))
    _check_rows(got, want, flipped)


@pytest.mark.parametrize("m,dim,inner", [(1, 512, 256), (130, 1024, 512),
                                         (8008, 1024, 512),
                                         (130, 1280, 1280)])
def test_int8_outproj_f32_kernel(cuda, m, dim, inner):
    """K11 at f32 equal to plain bit for bit (exact int32 sums, the same
    rounding points), one launch a call, two calls equal; all-zero rows of
    a give b + x there."""
    x, a, w, b = _outproj_args(np.random.default_rng(m + dim + inner + 2),
                               m, dim, inner, cuda)
    x, a = x.float(), a.float()
    a[0, [0, m - 1]] = 0
    args = (x, a, *int8_serving.quantize_weight(w), b)
    before = int8_serving.int8_outproj_residual_f32_cuda.launches
    got = int8_serving.int8_outproj_residual(*args)
    want = int8_serving.int8_outproj_residual_plain(*args)
    again = int8_serving.int8_outproj_residual(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)
    assert torch.equal(got[0, [0, m - 1]], b + x[0, [0, m - 1]])
    assert int8_serving.int8_outproj_residual_f32_cuda.launches == before + 2


@pytest.mark.parametrize("m,dim,hid", INT8_F32_MLP_CASES)
def test_int8_mlp_f32_kernel(cuda, m, dim, hid):
    """K12 at f32: f32 y, one launch a call, two calls bit-equal; its codes
    u8 plain's and its g8 plain's GELU of its own u8's product, each but
    for one-step flips; y plain's product of its own g8 bit for bit, and
    plain's within F32_TOL on the rows whose u8 and g8 are plain's own (g8
    also against plain's g8 of plain's own u8)."""
    args = _int8_mlp_args(np.random.default_rng(m + dim + hid + 3), m, dim,
                          hid, cuda)
    args = (args[0].float(),) + args[1:]
    x, gamma, beta, w1, s1, b1, w2, s2, b2 = args
    before = int8_serving.int8_mlp_block_f32_cuda.launches
    got = int8_serving.int8_mlp_block(*args)
    again = int8_serving.int8_mlp_block(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert int8_serving.int8_mlp_block_f32_cuda.launches == before + 2
    q8 = int8_serving
    y, piece = _int8_f32_scratch(q8.int8_mlp_block_f32_cuda, args,
                                 q8.mlp_plan(m, dim, hid))
    assert torch.equal(y, got)
    u8, s1_row = piece("u8", torch.int8, dim), piece("s1_row",
                                                     torch.float32, 1)
    g8, s2_row = piece("g8", torch.int8, hid), piece("s2_row",
                                                     torch.float32, 1)
    with nn.full_f32(torch.float32):
        codes, s_row = q8._rowquant(q8._ln(x, gamma, beta))
        flipped = _code_flips(u8, codes)
        h = q8._deq_dot(u8.float(), s1_row, w1, s1) + b1
        g_codes, _ = q8._rowquant(nn.gelu(h))
        flipped |= _code_flips(g8, g_codes)
        h = q8._deq_dot(codes, s_row, w1, s1) + b1
        flipped |= (g8.float() != q8._rowquant(nn.gelu(h))[0].reshape(
            g8.shape)).any(dim=1)
        mine = (q8._deq_dot(g8.float(), s2_row, w2, s2) + b2) + x.reshape(
            m, dim)
        want = q8.int8_mlp_block_plain(*args)
    assert torch.equal(got.reshape(m, dim), mine)
    _check_rows((got,), (want,), flipped)


@pytest.mark.parametrize("zero_bias", [True, False])
def test_int8_f32_kernels_zero_rows(cuda, zero_bias):
    """All-zero rows of x at a tile's first and last row and in the ragged
    tile: with beta (and b1) = 0, K10 at f32 gives q = k = v = 0 there and
    K12 at f32 gives y = b2 exactly."""
    rows = (0, 127, 128, 129)
    qkv = _int8_qkv_args(np.random.default_rng(5), 130, 256, 4, 64, cuda,
                         zero_rows=rows, zero_beta=zero_bias)
    qkv = (qkv[0].float(),) + qkv[1:]
    got = int8_serving.int8_ln_qkv_f32_cuda(*qkv)
    _check(got, int8_serving.int8_ln_qkv_plain(*qkv))
    mlp = _int8_mlp_args(np.random.default_rng(6), 130, 256, 384, cuda,
                         zero_rows=rows, zero_bias=zero_bias)
    mlp = (mlp[0].float(),) + mlp[1:]
    y = int8_serving.int8_mlp_block_f32_cuda(*mlp)
    _check(y, int8_serving.int8_mlp_block_plain(*mlp))
    if zero_bias:
        assert all(not t[0, list(rows)].abs().max() for t in got)
        assert torch.equal(y[0, list(rows)], mlp[-1].expand(len(rows), -1))


INT8_F32_ATTN_CASES = (
    [(1, 1, 1, 3, 64), (2, 70, 70, 3, 64), (2, 130, 97, 3, 64),
     (1, 1001, 900, 3, 64), (8, 1001, 1001, 8, 64), (8, 1001, 900, 8, 64),
     (2, 1001, 900, 2, 128)]
    + [(2, 130, nv, 2, d) for d in (16, 32, 80, 128) for nv in (1, 33, 130)])


@pytest.mark.parametrize("b,n,n_valid,h,d", INT8_F32_ATTN_CASES)
def test_int8_attention_f32_kernel(cuda, b, n, n_valid, h, d):
    """K13 at f32 against plain at head dims 16-128 (padded to 64 or 128),
    n_valid on and off the 32- and 64-key tiles, the flagship at batch 8,
    within F32_TOL (1 + |plain|) but for a counted few query rows
    (chip_smoke.py's hold_int8_attn_f32); f32 o, one launch a call, the
    bf16 K13 not launched, two calls bit-equal; keys past n_valid get p8 =
    0 and stay out of V's scale."""
    rng = np.random.default_rng(n + 7 * d + b + 11)
    q, k, v = (_f32(rng, (b, n, h, d), cuda) for _ in range(3))
    kw = {"scale": d ** -0.5, "n_valid": n_valid}
    before = (int8_serving.int8_flash_attention_f32_cuda.launches,
              int8_serving.int8_flash_attention_cuda.launches)
    got = int8_serving.int8_flash_attention(q, k, v, **kw)
    with nn.full_f32(torch.float32):
        want = int8_serving.int8_flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _chip_smoke().hold_int8_attn_f32("K13 at f32", got, want)
    assert (int8_serving.int8_flash_attention_f32_cuda.launches,
            int8_serving.int8_flash_attention_cuda.launches) == (
                before[0] + 1, before[1])
    assert torch.equal(got, int8_serving.int8_flash_attention(q, k, v, **kw))
    v[:, n_valid:] = 100.0
    assert torch.equal(got, int8_serving.int8_flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("n,n_valid,d", [(130, 97, 64), (1001, 900, 128),
                                         (1001, 1001, 64)])
def test_int8_attention_f32_prologue_codes(cuda, n, n_valid, d):
    """The prologue on f32 V: s_v and the codes are the IEEE quotients bit
    for bit, transposed and permuted as the bf16 K13's (v8_key_order),
    zero past n_valid."""
    from neurovit_tpu_torch.ops.common import FLOAT, INT, VOID, launch, ptr
    rng = np.random.default_rng(n_valid + d + 1)
    q, k, v = (_f32(rng, (2, n, 3, d), cuda) for _ in range(3))
    plan = int8_serving.int8_attn_f32_plan(2, n, 3, d)
    v8 = torch.zeros((6, d, plan.n_pad), dtype=torch.int8, device=cuda)
    stats = torch.zeros(plan.stats_bytes // 4, dtype=torch.float32,
                        device=cuda)
    launch("nvt_int8_attention_f32", (VOID,) * 6 + (INT,) * 5 + (FLOAT,), q,
           ptr(q), ptr(k), ptr(v), ptr(torch.empty_like(q)), ptr(v8),
           ptr(stats), 2, n, 3, d, n_valid, float(d ** -0.5 * fa.LOG2E))
    torch.cuda.synchronize()
    vf = v.permute(0, 2, 1, 3).reshape(6, n, d).double()
    amax = vf[:, :n_valid].abs().amax(dim=1)
    s_v = torch.where(amax > 0, (amax / 127).float(), 1.0)
    assert torch.equal(stats[:6 * d], s_v.reshape(-1))
    codes = torch.clamp(torch.round((vf / s_v[:, None].double()).float()),
                        -127, 127)
    reach = -(-n_valid // 64) * 64
    order = int8_serving.v8_key_order(reach).to(cuda)
    want = torch.zeros(6, reach, d, dtype=torch.int8, device=cuda)
    want[:, :n_valid] = codes[:, :n_valid].to(torch.int8)
    assert torch.equal(v8[:, :, :reach], want[:, order].transpose(1, 2))


def test_int8_f32_plans_match_the_kernels(cuda):
    """K13 f32's plan counts the attention kernel's shared memory as the
    kernel does; its scratch is the bf16 K13's, counted by the same
    functions. K10-K12 at f32 take the bf16 plans (their passes stage no
    activation in shared memory), which the bf16 tests hold."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    lib = _build.library()
    smem = lib.nvt_int8_attn_f32_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_longlong, [ctypes.c_int]
    v8b, statb = lib.nvt_int8_attn_v8_bytes, lib.nvt_int8_attn_stats_bytes
    for fn in (v8b, statb):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 4
    for b, n, h, d in [(1, 1001, 8, 64), (8, 1001, 8, 64), (2, 1001, 2, 128),
                       (2, 130, 2, 16), (8193, 16, 8, 16)] + [
            (8, 1001, heads, dh) for _, heads, dh, _ in WIDTHS.values()]:
        plan = int8_serving.int8_attn_f32_plan(b, n, h, d)
        assert smem(plan.d_kernel) == plan.launches[2][3], (b, n, h, d)
        assert v8b(b, n, h, plan.d_kernel) == plan.v8_bytes
        assert statb(b, n, h, plan.d_kernel) == plan.stats_bytes


def test_int8_f32_forward_runs_the_f32_int8_kernels(cuda):
    """An f32 ViT quantized to int8 on the card launches K10-K13 at f32 once
    a block and no other kernel, its logits within 1e-3 of the CPU plain
    path's on the same int8 weights; with int8_attn "off", K1 at f32 in
    place of K13."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.models.vit3d import quantize_blocks

    f32 = (int8_serving.int8_ln_qkv_f32_cuda,
           int8_serving.int8_flash_attention_f32_cuda,
           int8_serving.int8_outproj_residual_f32_cuda,
           int8_serving.int8_mlp_block_f32_cuda, fa.flash_attention_f32_cuda)
    others = (int8_serving.int8_ln_qkv_cuda,
              int8_serving.int8_flash_attention_cuda,
              int8_serving.int8_outproj_residual_cuda,
              int8_serving.int8_mlp_block_cuda, fa.flash_attention_cuda,
              fused_qkv.fused_ln_qkv_f32_cuda,
              fused_outproj.fused_outproj_residual_f32_cuda,
              fused_mlp.fused_mlp_block_f32_cuda)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 20, 20, 20)).astype(np.float32))
    for attn, want in (("pv", [2, 2, 2, 2, 0]), ("off", [2, 0, 2, 2, 2])):
        config = load_config(overrides={
            "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
            "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
            "MODEL_VIT_DIM": 256, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
            "MODEL_VIT_DIM_HEAD": 64, "MODEL_VIT_MLP_DIM": 512,
            "SERVING_INT8_ATTN": attn})
        logits = {}
        for device in ("cpu", cuda):
            model = NeuroEncoder(config, device=device, seed=4).eval()
            quantize_blocks(model.volume_encoder.vit3d)
            before = [fn.launches for fn in f32 + others]
            with torch.no_grad():
                logits[str(device)] = model(x.to(device)).cpu()
            torch.cuda.synchronize()
            if device == cuda:
                assert [fn.launches - b for fn, b in
                        zip(f32 + others, before)] == want + [0] * 8, attn
        torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-3,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# Tensor parallelism: the forms of ops/tp_forms.py at the flagship's shard
# widths (dim 1024, 8 heads of 64, MLP 2048 cut by tp 2 and 4), one volume
# ---------------------------------------------------------------------------

TP_DIM, TP_INNER, TP_MLP, TP_N = 1024, 512, 2048, 1001


def _tp_block(cuda, tp, dtype, seed=0):
    from neurovit_tpu_torch.parallel.tensor_parallel import cut
    rng = np.random.default_rng(seed)

    def w(o, i):
        return torch.tensor(rng.uniform(-1, 1, (o, i)) / i ** 0.5,
                            dtype=torch.float32, device=cuda)

    x = _rand(rng, (1, TP_N, TP_DIM), cuda, dtype)
    attn = _rand(rng, (1, TP_N, TP_INNER), cuda, dtype)
    ln = (_rand(rng, (TP_DIM,), cuda, torch.float32, 0.1, 1.0),
          _rand(rng, (TP_DIM,), cuda, torch.float32, 0.1))
    wout, w1, w2, wqkv = (w(TP_DIM, TP_INNER), w(TP_MLP, TP_DIM),
                          w(TP_DIM, TP_MLP), w(3 * TP_INNER, TP_DIM))
    bout, b1, b2 = (_rand(rng, (n,), cuda, torch.float32, 0.03)
                    for n in (TP_DIM, TP_MLP, TP_DIM))
    dy = _rand(rng, (1, TP_N, TP_DIM), cuda, dtype, 0.1)
    dqkv = _rand(rng, (1, TP_N, 3 * TP_INNER), cuda, dtype, 0.1)
    part, hid = TP_INNER // tp, TP_MLP // tp
    shards = []
    for m in range(tp):
        dq = dqkv.reshape(1, TP_N, 3, TP_INNER)[..., m * part:(m + 1) * part]
        shards.append({"attn": attn[..., m * part:(m + 1) * part]
                       .contiguous(), "wout": cut(wout, "row", m, tp),
                       "w1": cut(w1, "col", m, tp),
                       "b1": cut(b1, "col", m, tp),
                       "w2": cut(w2, "row", m, tp),
                       "wqkv": cut(wqkv, "heads", m, tp),
                       "dqkv": dq.reshape(1, TP_N, 3 * part).contiguous(),
                       "cols": slice(m * hid, (m + 1) * hid)})
    whole = dict(x=x, attn=attn, ln=ln, wout=wout, bout=bout, w1=w1, b1=b1,
                 w2=w2, b2=b2, wqkv=wqkv, dy=dy, dqkv=dqkv)
    return whole, shards


def _close_f32(got, want, tol=1e-4):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol * (1 + want.abs())).all(), \
        float((got - want).abs().max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_outproj_partial_kernel(cuda, tp, dtype, rate):
    """K3's tensor-parallel form on every shard against its plain version
    (f32 partials, bias and residual on the first shard alone), and the
    shards' f32 sum, rounded once, against the whole-width K3."""
    from neurovit_tpu_torch.ops import tp_forms as F
    wh, sh = _tp_block(cuda, tp, dtype)
    parts = []
    for m, s in enumerate(sh):
        kw = dict(first=m == 0, dropout_rate=rate, seed=9)
        got = F.outproj_partial(wh["x"], s["attn"], s["wout"], wh["bout"],
                                **kw)
        assert got.dtype == torch.float32
        _close_f32(got, F.outproj_partial_plain(wh["x"], s["attn"],
                                                s["wout"], wh["bout"], **kw))
        parts.append(got)
    whole = fused_outproj.fused_outproj_residual(
        wh["x"], wh["attn"], wh["wout"], wh["bout"], dropout_rate=rate,
        seed=9)
    summed = torch.stack(parts).sum(0).to(dtype)
    if dtype == torch.float32:
        _close_f32(summed, whole)
    else:
        _check(summed, whole)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mlp_partial_kernel(cuda, tp, dtype):
    """K4's form on every shard against plain (its h too), and the shards'
    sum against the whole-width K4 at dropout 0."""
    from neurovit_tpu_torch.ops import tp_forms as F
    wh, sh = _tp_block(cuda, tp, dtype)
    parts = []
    for m, s in enumerate(sh):
        args = (wh["x"], *wh["ln"], s["w1"], s["b1"], s["w2"], wh["b2"])
        y, h = F.mlp_partial(*args, first=m == 0, return_h=True)
        want_y, want_h = F.mlp_partial_plain(*args, first=m == 0,
                                             return_h=True)
        _check(h, want_h)
        torch.cuda.synchronize()
        assert ((y - want_y).abs() <= ATOL + RTOL * want_y.abs()).all()
        parts.append(y)
    whole = fused_mlp.fused_mlp_block(wh["x"], *wh["ln"], wh["w1"], wh["b1"],
                                      wh["w2"], wh["b2"])
    summed = torch.stack(parts).sum(0).to(dtype)
    if dtype == torch.float32:
        _close_f32(summed, whole)
    else:
        _check(summed, whole)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_ln_backward_partial_kernels(cuda, tp, dtype):
    """K9's form (dy added on the first shard) and K7's (its f32 instance
    is K7 f32 itself) against plain: f32 dx partials, dgamma and dbeta
    partials; the shards' dx summed and rounded once against the
    whole-width K9 and K7."""
    from neurovit_tpu_torch.ops import tp_forms as F
    wh, sh = _tp_block(cuda, tp, dtype)
    x, ln, dy = wh["x"], wh["ln"], wh["dy"]
    _, h = fused_mlp.fused_mlp_block_plain(x, *ln, wh["w1"], wh["b1"],
                                           wh["w2"], wh["b2"], return_h=True)
    dxs, dqs = [], []
    for m, s in enumerate(sh):
        hm = h[..., s["cols"]].contiguous()
        got = F.mlp_bwd_partial(dy, x, hm, *ln, s["w1"], s["w2"],
                                first=m == 0)
        want = F.mlp_bwd_partial_plain(dy, x, hm, *ln, s["w1"], s["w2"],
                                       first=m == 0)
        assert got[0].dtype == torch.float32
        torch.cuda.synchronize()
        tol = 1e-4 + 2e-2 * want[0].abs().max() + RTOL * want[0].abs()
        assert ((got[0] - want[0]).abs() <= tol).all()
        for g, w_ in zip(got[5:], want[5:]):
            assert float((g - w_).norm() / w_.norm()) <= 1e-2
        dxs.append(got[0])
        got = F.ln_qkv_bwd_partial(s["dqkv"], x, ln[0], s["wqkv"])
        want = F.ln_qkv_bwd_partial_plain(s["dqkv"], x, ln[0], s["wqkv"])
        torch.cuda.synchronize()
        tol = 1e-4 + 2e-2 * want[0].abs().max() + RTOL * want[0].abs()
        assert got[0].dtype == torch.float32
        assert ((got[0] - want[0]).abs() <= tol).all()
        dqs.append(got[0])
    bwd = (fused_mlp.fused_mlp_bwd_f32_cuda if dtype == torch.float32
           else fused_mlp.fused_mlp_bwd_cuda)
    whole = bwd(dy, x, h, *ln, wh["w1"], wh["w2"])[0]
    summed = torch.stack(dxs).sum(0).to(dtype)
    torch.cuda.synchronize()
    tol = 1e-4 + 2e-2 * whole.abs().max() + RTOL * whole.float().abs()
    assert ((summed.float() - whole.float()).abs() <= tol).all()
    k7 = (fused_qkv.fused_ln_qkv_bwd_f32_cuda if dtype == torch.float32
          else fused_qkv.fused_ln_qkv_bwd_cuda)
    whole = k7(wh["dqkv"], x, ln[0], wh["wqkv"])[0]
    summed = torch.stack(dqs).sum(0).to(dtype)
    torch.cuda.synchronize()
    tol = 1e-4 + 2e-2 * whole.abs().max() + RTOL * whole.float().abs()
    assert ((summed.float() - whole.float()).abs() <= tol).all()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_int8_split_row_quantize_kernels(cuda, tp, dtype):
    """K11's and K12's split row-quantize: the shards' row amax maxed over
    the model group gives the one-card K11's and K12's codes bit for bit;
    the forms' int32 accumulators are plain's; their sum through the
    epilogue is the one-card K11's and K12's output bit for bit."""
    from neurovit_tpu_torch.ops import tp_forms as F
    from neurovit_tpu_torch.parallel.tensor_parallel import cut
    q8 = int8_serving
    wh, sh = _tp_block(cuda, tp, dtype)
    x, ln = wh["x"], wh["ln"]
    rows = TP_N
    sfx = "_f32" if dtype == torch.float32 else ""
    w8, s8 = q8.quantize_weight(wh["wout"])
    plan = q8.int8_outproj_plan(rows, TP_DIM, TP_INNER)
    scr = q8._scratch(plan, x, None)
    one = q8._outproj_cuda(f"nvt_int8_outproj{sfx}", dtype, x, wh["attn"],
                           w8, s8, wh["bout"], scr)
    amax = torch.stack([F.int8_row_amax(s["attn"]) for s in sh]).amax(0)
    wrap = (F.int8_outproj_partial_f32_cuda if sfx
            else F.int8_outproj_partial_cuda)
    plan_m = q8.int8_outproj_plan(rows, TP_DIM, TP_INNER // tp)
    parts, codes = [], []
    for m, s in enumerate(sh):
        scr_m = q8._scratch(plan_m, x, None)
        got = wrap(s["attn"], amax, cut(w8, "row", m, tp), scratch=scr_m)
        want = F.int8_outproj_partial_plain(s["attn"], amax,
                                            cut(w8, "row", m, tp))
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)
        off, n = plan_m.scratch["a8"]
        codes.append(scr_m[off:off + n].view(torch.int8).reshape(rows, -1))
        parts.append(got)
    off, n = plan.scratch["a8"]
    assert torch.equal(torch.cat(codes, 1),
                       scr[off:off + n].view(torch.int8).reshape(rows, -1))
    acc = torch.stack(parts).sum(0, dtype=torch.int32)
    got = F.int8_dequant_residual(x, acc, amax, s8, wh["bout"])
    want = F.int8_dequant_residual_plain(x, acc, amax, s8, wh["bout"])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, one)
    (w18, s18), (w28, s28) = (q8.quantize_weight(wh["w1"]),
                              q8.quantize_weight(wh["w2"]))
    plan = q8.mlp_plan(rows, TP_DIM, TP_MLP)
    scr = q8._scratch(plan, x, None)
    one = q8._mlp_cuda(f"nvt_int8_mlp{sfx}", dtype, x, *ln, w18, s18,
                       wh["b1"], w28, s28, wh["b2"], scr)
    hidden = [F.int8_mlp_hidden(x, *ln, cut(w18, "col", m, tp),
                                cut(s18, "col", m, tp), s["b1"])
              for m, s in enumerate(sh)]
    gmax = torch.stack([a for _, a in hidden]).amax(0)
    plan_m = q8.mlp_plan(rows, TP_DIM, TP_MLP // tp)
    parts = []
    for m, (st, _) in enumerate(hidden):
        got = F.int8_mlp_partial(st, gmax, cut(w28, "row", m, tp))
        off, n = plan_m.scratch["g"]
        g = st[off:off + n].view(torch.float32).reshape(rows, -1)
        want = F.int8_mlp_partial_plain(g, gmax.reshape(rows),
                                        cut(w28, "row", m, tp))
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(rows, -1), want)
        parts.append(got)
    off, n = plan_m.scratch["g8"]
    codes = torch.cat([st[off:off + n].view(torch.int8).reshape(rows, -1)
                       for st, _ in hidden], 1)
    off, n = plan.scratch["g8"]
    torch.cuda.synchronize()
    assert torch.equal(codes,
                       scr[off:off + n].view(torch.int8).reshape(rows, -1))
    got = F.int8_dequant_residual(x, torch.stack(parts).sum(0,
                                                            dtype=torch.int32),
                                  gmax, s28, wh["b2"])
    torch.cuda.synchronize()
    assert torch.equal(got, one)


def test_tp_forms_launch_their_kernels(cuda):
    """Each form's wrapper counts one launch a call on CUDA tensors."""
    from neurovit_tpu_torch.ops import tp_forms as F
    wh, sh = _tp_block(cuda, 2, torch.bfloat16)
    before = F.outproj_partial_cuda.launches
    F.outproj_partial(wh["x"], sh[1]["attn"], sh[1]["wout"], wh["bout"],
                      first=False)
    assert F.outproj_partial_cuda.launches == before + 1
    before = F.int8_row_amax_cuda.launches
    amax = F.int8_row_amax(sh[0]["attn"])
    assert F.int8_row_amax_cuda.launches == before + 1
    w8 = torch.zeros(TP_DIM, TP_INNER // 2, dtype=torch.int8, device=cuda)
    before = F.int8_outproj_partial_cuda.launches
    acc = F.int8_outproj_partial(sh[0]["attn"], amax, w8)
    assert F.int8_outproj_partial_cuda.launches == before + 1
    before = F.int8_dequant_residual_cuda.launches
    F.int8_dequant_residual(wh["x"], acc, amax, wh["bout"], wh["bout"])
    assert F.int8_dequant_residual_cuda.launches == before + 1
