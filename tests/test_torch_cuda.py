"""The four Hopper kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the serving shapes are in chip_smoke.py).

These need an NVIDIA GPU with sm_90a and nvcc; elsewhere they skip. Run on
the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance, elementwise: |kernel - plain| <= 1e-2 + 2^-6 |plain|. The two
sides round to bf16 at the same points; an f32 sum taken in another order
can land on the other side of a rounding boundary, one bf16 ulp.
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv

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


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 512, device=cuda)              # f32, not bf16
    with pytest.raises(TypeError):
        fused_outproj.fused_outproj_residual(
            x, torch.zeros(1, 4, 128, device=cuda),
            torch.zeros(512, 128, device=cuda), torch.zeros(512, device=cuda))
    q = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention(q, q, q, scale=1.0)
