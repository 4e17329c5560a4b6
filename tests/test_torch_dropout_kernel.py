"""K16, the fused dropout of ``neurovit_tpu/ops/dropout.py``: the port's
plain version (``neurovit_tpu_torch.ops.dropout``) against a numpy
transcription of the Pallas body on the same 32-bit words, against JAX's
``dropout`` run in interpret mode (whose interpreter PRNG keeps every
element), its keep statistics, and its backward.

Exact comparisons throughout: both sides compute ``(x * mask) * s`` with s
= 1 / keep rounded to x's dtype, each product rounded to that dtype.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neurovit_tpu.ops import dropout as jdropout
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.ops import dropout as dr

torch.set_num_threads(1)

NP_DTYPES = {torch.bfloat16: ml_dtypes.bfloat16, torch.float32: np.float32}


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _mask_kernel_numpy(x: np.ndarray, bits: np.ndarray, keep: float):
    """neurovit_tpu/ops/dropout.py:30-35 in numpy, on the words ``bits``."""
    threshold = np.uint32(int(keep * 4294967295.0))
    mask = (bits < threshold).astype(x.dtype)
    return x * mask * x.dtype.type(1.0 / keep)


def test_threshold_and_scale():
    threshold, keep = dr.keep_threshold32(0.1)
    assert (threshold, keep) == (3865470565, 0.9)
    assert float(dr.scale_of(keep, torch.bfloat16)) == 1.109375
    assert float(dr.scale_of(keep, torch.float32)) == np.float32(1 / 0.9)
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            dr.keep_threshold32(rate)


def test_words_are_philox_by_position():
    """Word i is word i % 4 of Philox4x32-10(i // 4, seed), whatever the
    length asked for."""
    words = dr.random_words(77, 11)
    block = nn.philox4x32(torch.arange(3), 77).reshape(-1)
    assert torch.equal(words, block[:11])
    assert torch.equal(dr.random_words(77, 5), words[:5])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_matches_numpy_transcription(dtype, rate):
    x = _x((37, 24), dtype)
    words = dr.random_words(1234, x.numel())
    got = dr.dropout_plain(x, rate, 1234)
    xn = x.float().numpy().astype(NP_DTYPES[dtype])
    want = _mask_kernel_numpy(xn, words.numpy().astype(np.uint32).reshape(
        x.shape), 1.0 - rate)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    # Words at the threshold and one below it: dropped, kept.
    threshold, _ = dr.keep_threshold32(rate)
    edge = torch.tensor([threshold, threshold - 1], dtype=torch.int64)
    out = dr.apply_words(torch.ones(2, dtype=dtype), edge, rate)
    assert out[0] == 0 and out[1] == dr.scale_of(1.0 - rate, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_matches_jax_interpret_with_every_word_kept(dtype):
    """JAX's dropout in interpret mode keeps every element (its interpreter
    PRNG), so it is x * bf16(1/0.9) = x * 1.109375 in bf16; the port on
    words all below the threshold gives the same bits, forward and
    backward."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _x((64, 256), dtype, seed=3)
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        want = jdropout.dropout(jax.random.key(0), xj, 0.1)
        g = jax.grad(lambda a: jnp.sum(jdropout.dropout(
            jax.random.key(0), a, 0.1).astype(jnp.float32) * 3.0))(xj)
    zeros = torch.zeros(x.numel(), dtype=torch.int64)
    got = dr.apply_words(x, zeros, 0.1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    got_g = dr.apply_words(torch.full_like(x, 3.0), zeros, 0.1)
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(g.astype(jnp.float32)))
    if dtype == torch.bfloat16:
        assert float(got_g[0, 0]) == 3.0 * 1.109375


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction_and_mean(rate):
    """Over 2^18 elements of ones: the kept fraction within 4 sigma of the
    quantized keep threshold / 2^32, and the mean of the output within 4
    sigma of keep * s (the inverted scale keeps the mean up to s's
    rounding)."""
    n = 1 << 18
    y = dr.dropout_plain(torch.ones(n), rate, 99)
    threshold, keep = dr.keep_threshold32(rate)
    p = threshold / 2.0 ** 32
    sigma = (p * (1 - p) / n) ** 0.5
    kept = float((y != 0).float().mean())
    assert abs(kept - p) <= 4 * sigma
    s = float(dr.scale_of(keep, torch.float32))
    assert abs(float(y.mean()) - p * s) <= 4 * sigma * s
    assert abs(p * s - 1.0) < 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_is_mask_scale_g(dtype):
    """The gradient is the same kernel on the cotangent: mask * s * g, the
    forward's mask, through the autograd Function; rate 0 returns x."""
    x = _x((5, 33), dtype, seed=1).requires_grad_()
    y = dr.dropout(x, 0.1, 42)
    g = _x((5, 33), dtype, seed=2)
    y.backward(g)
    threshold, keep = dr.keep_threshold32(0.1)
    mask = (dr.random_words(42, x.numel()) < threshold).reshape(x.shape)
    want = (g * mask.to(dtype)) * dr.scale_of(keep, dtype)
    assert torch.equal(x.grad, want)
    assert torch.equal(y.detach(), dr.dropout_plain(x.detach(), 0.1, 42))
    assert torch.equal((y != 0), mask | (x == 0))
    assert dr.dropout(x, 0.0, 42) is x
