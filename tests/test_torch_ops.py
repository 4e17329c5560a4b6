"""The port's ops (plain PyTorch on CPU tensors) against the JAX package's
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

Tolerances: f32 rtol = atol = 1e-4 (sums taken in another order); bf16
atol 5e-2 (both sides round at the same points; an f32 sum taken in
another order can move a value across a bf16 rounding boundary, one bf16
ulp, up to 3e-2 at the magnitudes here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.ops import flash_attention as jfa
from neurovit_tpu.ops import fused_mlp as jmlp
from neurovit_tpu.ops import fused_outproj as jout
from neurovit_tpu.ops import fused_qkv as jqkv
from neurovit_tpu_torch.ops.flash_attention import flash_attention
from neurovit_tpu_torch.ops.fused_mlp import fused_mlp_block
from neurovit_tpu_torch.ops.fused_outproj import fused_outproj_residual
from neurovit_tpu_torch.ops.fused_qkv import fused_ln_qkv

torch.set_num_threads(1)

B, DIM, HEADS, DIM_HEAD, MLP = 2, 64, 4, 16, 96
INNER = HEADS * DIM_HEAD
DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-4, atol=1e-4)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=0, atol=5e-2))}


def _act(rng, shape, jdt):
    """One activation for both packages: rounded to the dtype once, in JAX,
    and handed to torch with exactly those values."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)
    return j, np.asarray(j.astype(jnp.float32))


def _t(a, tdt=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j.astype(jnp.float32)), **tol)


def _ln_params(rng):
    return (1.0 + 0.2 * rng.standard_normal(DIM)).astype(np.float32), \
        (0.1 * rng.standard_normal(DIM)).astype(np.float32)


def _linear(rng, fan_in, fan_out):
    """JAX layout [in, out] + bias, nn.Linear's default range."""
    bound = fan_in ** -0.5
    return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            rng.uniform(-bound, bound, fan_out).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,n_valid", [(17, 13), (33, 30)])
def test_flash_attention_matches_jax(dtype, n, n_valid):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(n)
    (qj, qn), (kj, kn), (vj, vn) = (_act(rng, (B, n, HEADS, DIM_HEAD), jdt)
                                    for _ in range(3))
    scale = DIM_HEAD ** -0.5
    want = jfa.flash_attention(qj, kj, vj, scale=scale, n_valid=n_valid,
                               layout="bnhd")
    got = flash_attention(_t(qn, tdt), _t(kn, tdt), _t(vn, tdt), scale=scale,
                          n_valid=n_valid)
    assert got.shape == (B, n, HEADS, DIM_HEAD) and got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 33])
def test_fused_ln_qkv_matches_jax(dtype, n):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(100 + n)
    xj, xn = _act(rng, (B, n, DIM), jdt)
    gamma, beta = _ln_params(rng)
    w, _ = _linear(rng, DIM, 3 * INNER)
    block = {"attn_norm": {"scale": jnp.asarray(gamma),
                           "bias": jnp.asarray(beta)},
             "qkv": {"kernel": jnp.asarray(w)}}
    want = jqkv.fused_ln_qkv(block, xj, HEADS, DIM_HEAD)
    got = fused_ln_qkv(_t(xn, tdt), _t(gamma), _t(beta), _t(w.T), HEADS,
                       DIM_HEAD)
    for g, wj in zip(got, want):
        assert g.shape == (B, n, HEADS, DIM_HEAD) and g.dtype == tdt
        _close(g, wj, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 33])
def test_fused_outproj_residual_matches_jax(dtype, n):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(200 + n)
    xj, xn = _act(rng, (B, n, DIM), jdt)
    aj, an = _act(rng, (B, n, INNER), jdt)
    w, b = _linear(rng, INNER, DIM)
    want = jout.fused_outproj_residual(
        {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, xj, aj,
        deterministic=True)
    got = fused_outproj_residual(_t(xn, tdt), _t(an, tdt), _t(w.T), _t(b))
    assert got.shape == (B, n, DIM) and got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 33])
def test_fused_mlp_block_matches_jax(dtype, n):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(300 + n)
    xj, xn = _act(rng, (B, n, DIM), jdt)
    gamma, beta = _ln_params(rng)
    w1, b1 = _linear(rng, DIM, MLP)
    w2, b2 = _linear(rng, MLP, DIM)
    params = {"mlp_norm": {"scale": jnp.asarray(gamma),
                           "bias": jnp.asarray(beta)},
              "fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
              "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    want = jmlp.fused_mlp_block(params, xj, deterministic=True)
    got = fused_mlp_block(_t(xn, tdt), _t(gamma), _t(beta), _t(w1.T),
                          _t(b1), _t(w2.T), _t(b2))
    assert got.shape == (B, n, DIM) and got.dtype == tdt
    _close(got, want, tol)


def test_flash_attention_masks_keys_past_n_valid():
    """Keys at or past n_valid get exactly zero weight: changing them does
    not change the output."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 17, HEADS, DIM_HEAD))
                                .astype(np.float32)) for _ in range(3))
    out = flash_attention(q, k, v, scale=0.25, n_valid=11)
    k2, v2 = k.clone(), v.clone()
    k2[:, 11:] = 100.0
    v2[:, 11:] = -7.0
    assert torch.equal(out, flash_attention(q, k2, v2, scale=0.25,
                                            n_valid=11))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, scale=0.25, n_valid=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, scale=0.25, n_valid=18)


def test_ops_refuse_mixed_devices():
    """A CPU tensor never silently meets another device: the dispatch rule
    raises instead of falling back."""
    x = torch.zeros(1, 3, DIM)
    meta = torch.zeros(DIM, device="meta")
    with pytest.raises(ValueError):
        fused_outproj_residual(x, torch.zeros(1, 3, INNER),
                               torch.zeros(DIM, INNER), meta)
