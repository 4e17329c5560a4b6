"""The port's max-pool K14/K15 plain versions against the JAX package's
Pallas kernels in interpret mode (as tests/test_maxpool_pallas.py runs
them), on that file's four shapes, f32 and bf16, tie-free, tie-heavy and
with NaN and +-inf in the windows.

Tolerances: values and codes bit-equal (both sides compare in f32 and pick
the same winner); the backward's f32 sums within 1e-6 (the same at most 8
terms per input element, added in another order), its bf16 results
bit-equal (one rounding of those sums); NaN where JAX has NaN (both
propagate it as jnp.maximum does, and a NaN loses every strict '>', so
the code stays where it was). The autograd Function against
``jax.grad`` of ``max_pool3d_pallas``: the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import maxpool3d as jmp
from neurovit_tpu_torch.ops import maxpool3d as mp

torch.set_num_threads(1)

SHAPES = [(2, 9, 7, 10, 8),    # odd/even mix
          (1, 8, 8, 8, 4),     # all even
          (2, 5, 6, 9, 16),    # odd depth
          (3, 10, 5, 5, 8)]    # stem-like aspect


def _input(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "tie_free":
        # Distinct bf16 bit patterns of both signs (16384 values, exact in
        # bf16 and f32): no window ties in either dtype.
        bits = np.concatenate([np.arange(0x3000, 0x5000),
                               np.arange(0xB000, 0xD000)]).astype(np.uint32)
        pick = rng.choice(bits, int(np.prod(shape)), replace=False)
        return (pick << 16).view(np.float32).reshape(shape)
    if kind == "nan_inf":
        # Continuous values with 3 % NaN, 3 % +inf and 6 % -inf, so windows
        # hold NaN beside larger values, ties at +inf, and all -inf taps.
        a = rng.standard_normal(shape).astype(np.float32)
        pick = rng.random(shape)
        a[pick < 0.03] = np.nan
        a[(pick >= 0.03) & (pick < 0.06)] = np.inf
        a[(pick >= 0.06) & (pick < 0.12)] = -np.inf
        return a
    # Post-ReLU activations in bf16: zeros and small integers, so most
    # windows hold ties, and all-zero windows occur.
    return np.maximum(rng.integers(-3, 4, shape), 0).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["tie_free", "tie_heavy", "nan_inf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pool_and_gradient_match_pallas(shape, kind, dtype):
    a = _input(kind, shape, seed=sum(shape))
    jx, tx = _pair(a, dtype)
    jout, jcodes = jmp.max_pool3d_argmax(jx)
    out, codes = mp.max_pool3d_argmax(tx)
    assert out.dtype == tx.dtype and codes.dtype == torch.uint8
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(codes.numpy().astype(np.int32),
                                  np.asarray(jcodes))
    if kind == "tie_heavy":
        assert (np.asarray(jcodes) != 13).mean() > 0.2   # not just centres
    if kind == "nan_inf":
        assert np.isnan(_np(out)).any() and np.isposinf(_np(out)).any()

    g = np.random.default_rng(7).standard_normal(out.shape).astype(np.float32)
    jg, tg = _pair(g, dtype)
    want = jmp.max_pool3d_argmax_bwd(jcodes, jg, jx.shape, jx.dtype)
    got = mp.max_pool3d_argmax_bwd(codes, tg, tuple(tx.shape), tx.dtype)
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["tie_free", "tie_heavy"])
def test_autograd_function_matches_jax_grad(kind, dtype):
    shape = SHAPES[0]
    a = _input(kind, shape, seed=11)
    jx, tx = _pair(a, dtype)
    g = np.random.default_rng(12).standard_normal(
        (2, 5, 4, 5, 8)).astype(np.float32)
    jg, tg = _pair(g, dtype)
    want = jax.grad(lambda v: jnp.vdot(
        jmp.max_pool3d_pallas(v).astype(jnp.float32),
        jg.astype(jnp.float32)))(jx)
    tx.requires_grad_()
    out = mp.max_pool3d(tx)
    (got,) = torch.autograd.grad(out, tx, grad_outputs=tg)
    np.testing.assert_array_equal(_np(out.detach()),
                                  _np(jmp.max_pool3d_pallas(jx)))
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def test_all_equal_window_routes_to_one_winner():
    """An all-zero input: every window ties everywhere; the whole cotangent
    of each window goes to its first winner, as the Pallas kernel routes
    it (tests/test_maxpool_pallas.py::test_tie_routes_full_gradient_to_one
    _winner), not split as XLA's autodiff splits it."""
    x = torch.zeros(1, 4, 4, 4, 1, requires_grad=True)
    out = mp.max_pool3d(x)
    (dx,) = torch.autograd.grad(out, x, grad_outputs=torch.ones_like(out))
    assert set(np.unique(dx.numpy())) <= {0.0, 1.0, 2.0, 4.0, 8.0}
    assert float(dx.sum()) == out.numel()
    want = jax.grad(lambda v: jnp.vdot(jmp.max_pool3d_pallas(v),
                                       jnp.ones((1, 2, 2, 2, 1))))(
        jnp.zeros((1, 4, 4, 4, 1)))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want))
