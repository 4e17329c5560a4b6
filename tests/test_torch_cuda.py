"""The Hopper kernels against their plain PyTorch versions on the card, at
small and ragged shapes (the model's shapes are in chip_smoke.py): the
forward kernels K1-K4 with and without dropout, the backward kernels K5,
K7, K8 and K9, K6 (the [B, H, N, D] attention, forward and backward) and
the Grad-CAM probe that runs it, and the int8 serving kernels K10-K13.

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
code by one step, which moves an output by far less than 1e-2.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                    int8_serving)

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
def test_fused_ln_qkv_bwd_kernel(cuda, m):
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
    dq, dk, dv = (_rand(rng, (1, m, 2, 64), cuda) for _ in range(3))
    _check_grads(fused_qkv.fused_ln_qkv_bwd_cuda(dq, dk, dv, x, gamma, w),
                 fused_qkv.fused_ln_qkv_bwd_plain(dq, dk, dv, x, gamma, w),
                 params=(1, 2))


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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [1, 33, 65, 300])
def test_fused_mlp_fwd_bwd_kernels(cuda, m, rate):
    rng = np.random.default_rng(m + 3)
    x = _rand(rng, (1, m, 256), cuda)
    gamma = _rand(rng, (256,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (256,), cuda, torch.float32, 0.1)
    w1 = _rand(rng, (384, 256), cuda, torch.bfloat16, 256 ** -0.5)
    b1 = _rand(rng, (384,), cuda, torch.float32, 0.05)
    w2 = _rand(rng, (256, 384), cuda, torch.bfloat16, 384 ** -0.5)
    b2 = _rand(rng, (256,), cuda, torch.float32, 0.05)
    kw = {"dropout_rate": rate, "seeds": (8, 9)}
    args = (x, gamma, beta, w1, b1, w2, b2)
    _check(fused_mlp.fused_mlp_block_cuda(*args, return_h=True, **kw),
           fused_mlp.fused_mlp_block_plain(*args, return_h=True, **kw))
    _, h = fused_mlp.fused_mlp_block_plain(*args, return_h=True, **kw)
    dy = _rand(rng, (1, m, 256), cuda)
    got = fused_mlp.fused_mlp_bwd_cuda(dy, x, h, gamma, beta, w1, w2, **kw)
    want = fused_mlp.fused_mlp_bwd_plain(dy, x, h, gamma, beta, w1, w2, **kw)
    got = [t.reshape(w.shape) for t, w in zip(got, want)]
    _check_grads(got, want, params=(5, 6))


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
    x = torch.zeros(1, 4, 512, device=cuda)              # f32, not bf16
    with pytest.raises(TypeError):
        fused_outproj.fused_outproj_residual(
            x, torch.zeros(1, 4, 128, device=cuda),
            torch.zeros(512, 128, device=cuda), torch.zeros(512, device=cuda))
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention(q, q, q, scale=1.0)


def _int8_weight(rng, out_f, in_f, device):
    w = _rand(rng, (out_f, in_f), device, torch.float32, in_f ** -0.5)
    return int8_serving.quantize_weight(w)


@pytest.mark.parametrize("m", [1, 65, 300])
def test_int8_ln_qkv_kernel(cuda, m):
    rng = np.random.default_rng(m + 4)
    x = _rand(rng, (1, m, 512), cuda)
    gamma = _rand(rng, (512,), cuda, torch.float32, 0.1, 1.0)
    beta = _rand(rng, (512,), cuda, torch.float32, 0.1)
    w8, s = _int8_weight(rng, 3 * 256, 512, cuda)
    args = (x, gamma, beta, w8, s, 4, 64)
    before = int8_serving.int8_ln_qkv_cuda.launches
    _check(int8_serving.int8_ln_qkv(*args),
           int8_serving.int8_ln_qkv_plain(*args))
    assert int8_serving.int8_ln_qkv_cuda.launches == before + 1


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


@pytest.mark.parametrize("b,n,n_valid", [(1, 1, 1), (2, 70, 70),
                                         (2, 130, 97), (1, 1001, 900)])
def test_int8_attention_kernel(cuda, b, n, n_valid):
    """Ragged n_valid: keys past it get p8 = 0 and stay out of V's scale."""
    rng = np.random.default_rng(n + 7)
    q, k, v = (_rand(rng, (b, n, 3, 64), cuda) for _ in range(3))
    kw = {"scale": 0.125, "n_valid": n_valid}
    before = int8_serving.int8_flash_attention_cuda.launches
    got = int8_serving.int8_flash_attention(q, k, v, **kw)
    _check(got, int8_serving.int8_flash_attention_plain(q, k, v, **kw))
    assert int8_serving.int8_flash_attention_cuda.launches == before + 1
    v[:, n_valid:] = 100.0
    assert torch.equal(got, int8_serving.int8_flash_attention(q, k, v, **kw))


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    """A shape each int8 kernel refuses, and an f32 weight."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    bf, i8 = torch.bfloat16, torch.int8
    with pytest.raises(ValueError, match="width % 256"):      # dim 128
        int8_serving.int8_ln_qkv(zeros(1, 4, 128, dtype=bf), zeros(128),
                                 zeros(128), zeros(384, 128, dtype=i8),
                                 zeros(384), 2, 64)
    with pytest.raises(ValueError, match="dim % 512"):        # dim 256
        int8_serving.int8_outproj_residual(
            zeros(1, 4, 256, dtype=bf), zeros(1, 4, 256, dtype=bf),
            zeros(256, 256, dtype=i8), zeros(256), zeros(256))
    with pytest.raises(ValueError, match="width % 256"):      # dim 1280
        int8_serving.int8_mlp_block(
            zeros(1, 4, 1280, dtype=bf), zeros(1280), zeros(1280),
            zeros(256, 1280, dtype=i8), zeros(256), zeros(256),
            zeros(1280, 256, dtype=i8), zeros(1280), zeros(1280))
    q = zeros(1, 4, 2, 32, dtype=bf)
    with pytest.raises(ValueError, match="head dim 64"):
        int8_serving.int8_flash_attention(q, q, q, scale=1.0)
    with pytest.raises(TypeError):                            # f32 weight
        int8_serving.int8_outproj_residual(
            zeros(1, 4, 512, dtype=bf), zeros(1, 4, 256, dtype=bf),
            zeros(512, 256), zeros(512), zeros(512))
