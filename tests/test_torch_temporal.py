"""The port's 4D temporal layer and projection against the JAX package's
(``neurovit_tpu/models/temporal.py``) on the same weights and inputs.

Forward and gradients (``jax.vjp``) at d_model 2 (the reference's 4D head:
num_classes 2, head dim 1) and 8, dropout 0: f32 within 1e-5 + 1e-4 rel,
bf16 forwards within 5e-2 of the largest magnitude. The attention is
``_sdpa_xla``'s row-max softmax, not K1's exp2 softmax clamped at +-96: a
case whose scores the clamp bites tells them apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.models import temporal as jax_temporal
from neurovit_tpu.ops.attention import _sdpa_xla
from neurovit_tpu_torch.models import temporal
from neurovit_tpu_torch.ops.attention import sdpa
from neurovit_tpu_torch.training.state_dict import _temporal_state_dict

torch.set_num_threads(1)

B, T = 2, 5
PREFIX = "temporal_transformer."


def _pair(d_model, seed=0):
    """The JAX layer's params (numpy) and the port's layer with them."""
    cfg = jax_temporal.TemporalConfig(d_model=d_model, nhead=2, dropout=0.0)
    params = jax.tree.map(np.asarray,
                          jax_temporal.init(jax.random.key(seed), cfg))
    layer = temporal.TemporalTransformer(
        temporal.TemporalConfig(d_model=d_model, nhead=2, dropout=0.0))
    weights = _temporal_state_dict({"temporal": params,
                                    "projection": {"kernel": np.zeros(1),
                                                   "bias": np.zeros(1)}})
    layer.load_state_dict({k[len(PREFIX):]: v for k, v in weights.items()
                           if k.startswith(PREFIX)}, strict=True)
    return cfg, params, layer


def _inputs(d_model, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, T, d_model))).astype(np.float32)


@pytest.mark.parametrize("d_model", [2, 8])
def test_forward_matches_jax_f32(d_model):
    cfg, params, layer = _pair(d_model)
    x = _inputs(d_model)
    want = jax_temporal.apply(params, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("d_model", [2, 8])
def test_forward_matches_jax_bf16(d_model):
    cfg, params, layer = _pair(d_model, seed=3)
    x = _inputs(d_model, seed=4)
    want = np.asarray(jax_temporal.apply(
        params, jnp.asarray(x).astype(jnp.bfloat16), cfg), np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=5e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("d_model", [2, 8])
def test_gradients_match_jax_vjp(d_model):
    """The input's and every parameter's gradient of <y, g> for a seeded
    cotangent g, against ``jax.vjp``."""
    cfg, params, layer = _pair(d_model, seed=5)
    x = _inputs(d_model, seed=6)
    g = _inputs(d_model, seed=7)
    y, vjp = jax.vjp(lambda p, v: jax_temporal.apply(p, v, cfg), params,
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-5)
    want = _temporal_state_dict({
        "temporal": jax.tree.map(np.asarray, dparams),
        "projection": {"kernel": np.zeros(1), "bias": np.zeros(1)}})
    grads = dict(layer.named_parameters())
    for key, w in want.items():
        if not key.startswith(PREFIX):
            continue
        got = grads[key[len(PREFIX):]].grad
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_projection_head_matches_jax_linear():
    rng = np.random.default_rng(8)
    kernel = rng.standard_normal((2, 2)).astype(np.float32)
    bias = rng.standard_normal(2).astype(np.float32)
    x = rng.standard_normal((B, 2)).astype(np.float32)
    from neurovit_tpu import nn as jax_nn
    want = jax_nn.linear({"kernel": jnp.asarray(kernel),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x))
    head = temporal.ProjectionHead(2, 2)
    head.load_state_dict({"projection_head.weight": torch.from_numpy(
        kernel.T.copy()), "projection_head.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_is_the_row_max_softmax_not_k1s(dtype):
    """Scores of several hundred: the row-max softmax puts all weight on
    the largest score (JAX's _sdpa_xla and the port's temporal attention
    agree), while K1's exp2 softmax clamped at +-96 (the port's
    ops.attention.sdpa) saturates every score to 2^96 and averages."""
    q = np.array([[[[30.0], [-20.0]]]], np.float32)          # [1, 1, 2, 1]
    k = np.array([[[[10.0], [5.0]]]], np.float32)
    v = np.array([[[[1.0], [-1.0]]]], np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(_sdpa_xla(*(jnp.asarray(a).astype(jdt)
                                  for a in (q, k, v)),
                                scale=1.0, dropout_rate=0.0, dropout_rng=None,
                                deterministic=True), np.float32)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    got = temporal.attention(*args, scale=1.0).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, 0, :, 0], [1.0, -1.0])
    clamped = sdpa(*args, scale=1.0).float().numpy()
    np.testing.assert_allclose(clamped[0, 0, :, 0], [0.0, 0.0], atol=1e-2)


def test_attention_dropout_keeps_exactly_one_minus_p():
    """The probabilities' dropout: an exact 1 - p keep (not q/256) and
    attn / keep, deterministic in the site key."""
    shape = (4, 2, 64, 64)
    mask = temporal.keep_mask_exact(123, shape, 0.9)
    assert mask.shape == shape
    frac = float(mask.float().mean())
    assert abs(frac - 0.9) < 4 * (0.9 * 0.1 / mask.numel()) ** 0.5
    assert torch.equal(mask, temporal.keep_mask_exact(123, shape, 0.9))
    assert not torch.equal(mask, temporal.keep_mask_exact(124, shape, 0.9))
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 1)).astype(
        np.float32)) for _ in range(3))
    full = temporal.attention(q, k, v, scale=1.0)
    dropped = temporal.attention(q, k, v, scale=1.0, dropout_rate=0.1,
                                 seed=5)
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
    m = temporal.keep_mask_exact(5, attn.shape, 0.9)
    want = torch.matmul(torch.where(m, attn / 0.9, torch.zeros_like(attn)),
                        v)
    torch.testing.assert_close(dropped, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(dropped, full)


def test_layer_dropout_sites_follow_the_seed():
    """With dropout on, the layer is a function of the step seed: the same
    seed gives the same output, another seed another output."""
    layer = temporal.TemporalTransformer(
        temporal.TemporalConfig(d_model=8, nhead=2, dropout=0.1))
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs(8, seed=11))
    with torch.no_grad():
        a, b = layer(x, 0.1, seed=7), layer(x, 0.1, seed=7)
        c, d = layer(x, 0.1, seed=8), layer(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_init_follows_the_reference():
    """xavier-uniform in_proj, zero in/out biases, LayerNorm ones/zeros,
    Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    layer = temporal.TemporalTransformer(temporal.TemporalConfig(d_model=2))
    layer.reset_parameters(torch.Generator().manual_seed(0))
    l0 = layer.transformer.layers[0].requires_grad_(False)
    assert float(l0.self_attn.in_proj_weight.abs().max()) <= (6 / 8) ** 0.5
    assert not l0.self_attn.in_proj_bias.any()
    assert not l0.self_attn.out_proj.bias.any()
    assert float(l0.linear2.weight.abs().max()) <= 2048 ** -0.5
    assert torch.equal(l0.norm1.weight, torch.ones(2))
    with pytest.raises(ValueError, match="nhead"):
        temporal.TemporalConfig(d_model=3, nhead=2)
