"""The port's four ops, forward and hand-written backward (plain PyTorch on
CPU tensors, through their ``autograd.Function``s), against ``jax.vjp`` of
the JAX package's Pallas custom VJPs (interpret mode on the CPU, dropout 0)
on the same numpy inputs and upstream cotangents; and, with dropout 0.1,
against central differences of the port's own plain forward with the masks
fixed by the seed.

Tolerances: f32 within 1e-5 abs + 1e-4 rel (sums in another order); bf16
within 5e-2 of max|ref| (the same rounding points; an f32 sum in another
order moves a bf16 value by an ulp now and then, and the backward rounds
ds, dz and dh to bf16 before its GEMMs). Finite differences: 2e-2 of the
directional derivative (f32 forward, step 1e-2).
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

B, N, N_VALID, DIM, HEADS, DIM_HEAD, MLP = 2, 65, 60, 64, 4, 16, 128
INNER = HEADS * DIM_HEAD
M = B * N
SCALE = DIM_HEAD ** -0.5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, jdt, tdt, grad=True):
    """One array for both packages, rounded to the dtype once in JAX."""
    j = jnp.asarray(np.asarray(a, np.float32)).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t.requires_grad_(grad)


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-2 * float(np.abs(want).max()))


def _vjp(fn, primals, cot):
    out, pull = jax.vjp(fn, *primals)
    return out, pull(cot)


def _run_torch(fn, inputs, cot):
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, cots)
    return outs, [t.grad for t in inputs]


def _ln(rng):
    return 1.0 + 0.2 * rng.standard_normal(DIM), 0.1 * rng.standard_normal(DIM)


def _lin(rng, fan_in, fan_out):
    bound = fan_in ** -0.5
    return (rng.uniform(-bound, bound, (fan_in, fan_out)),
            rng.uniform(-bound, bound, fan_out))


# --- the four ops against jax.vjp ------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_grad_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((B, N, HEADS, DIM_HEAD)), jdt, tdt)
        for _ in range(3))
    gj, gt = _pair(rng.standard_normal((B, N, HEADS, DIM_HEAD)), jdt, tdt,
                   grad=False)
    seed = jnp.zeros((1, 1), jnp.int32)
    out, grads = _vjp(lambda q, k, v: jfa._flash(q, k, v, SCALE, 0.0, N_VALID,
                                                 seed, "bnhd"),
                      (qj, kj, vj), gj)
    (o,), tgrads = _run_torch(
        lambda q, k, v: flash_attention(q, k, v, scale=SCALE,
                                        n_valid=N_VALID), (qt, kt, vt), gt)
    _close(o, out, dtype)
    for g, w in zip(tgrads, grads):
        _close(g, w, dtype)
    # Keys past n_valid get exactly zero gradient.
    assert not kt.grad[:, N_VALID:].any() and not vt.grad[:, N_VALID:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_ln_qkv_grad_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((M, DIM)), jdt, tdt)
    gamma, beta = _ln(rng)
    (gj, gt), (bj, bt) = (_pair(a, jnp.float32, torch.float32)
                          for a in (gamma, beta))
    w, _ = _lin(rng, DIM, 3 * INNER)
    wj, wt = _pair(w, jdt, tdt, grad=False)
    wt = wt.t().contiguous().requires_grad_(True)        # torch [out, in]
    cots = [_pair(rng.standard_normal((M, INNER)), jdt, tdt, grad=False)
            for _ in range(3)]
    outs, grads = _vjp(jqkv._fused, (xj, gj, bj, wj),
                       tuple(c[0] for c in cots))

    def port(x, g, b, w):
        q, k, v = fused_ln_qkv(x.reshape(B, N, DIM), g, b, w, HEADS,
                               DIM_HEAD)
        return tuple(t.reshape(M, INNER) for t in (q, k, v))

    touts, tgrads = _run_torch(port, (xt, gt, bt, wt),
                               tuple(c[1] for c in cots))
    for o, w_ in zip(touts, outs):
        _close(o, w_, dtype)
    dx, dg, db, dw = grads
    _close(tgrads[0], dx, dtype)
    _close(tgrads[1], dg, dtype)
    _close(tgrads[2], db, dtype)
    _close(tgrads[3].t(), dw, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_outproj_grad_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    aj, at = _pair(rng.standard_normal((M, INNER)), jdt, tdt)
    xj, xt = _pair(rng.standard_normal((M, DIM)), jdt, tdt)
    w, b = _lin(rng, INNER, DIM)
    wj, wt = _pair(w, jdt, tdt, grad=False)
    wt = wt.t().contiguous().requires_grad_(True)
    bj, bt = _pair(b, jnp.float32, torch.float32)
    cj, ct = _pair(rng.standard_normal((M, DIM)), jdt, tdt, grad=False)
    seed = jnp.zeros((1, 1), jnp.int32)
    out, grads = _vjp(lambda a, x, w, b: jout._fused(a, x, w, b, seed, 0.0),
                      (aj, xj, wj, bj), cj)
    (y,), tgrads = _run_torch(
        lambda a, x, w, b: fused_outproj_residual(
            x.reshape(B, N, DIM), a.reshape(B, N, INNER), w, b).reshape(M, DIM),
        (at, xt, wt, bt), ct)
    _close(y, out, dtype)
    da, dx, dw, db = grads
    _close(tgrads[0], da, dtype)
    _close(tgrads[1], dx, dtype)
    _close(tgrads[2].t(), dw, dtype)
    _close(tgrads[3], db, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_mlp_grad_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((M, DIM)), jdt, tdt)
    gamma, beta = _ln(rng)
    (gj, gt), (bej, bet) = (_pair(a, jnp.float32, torch.float32)
                            for a in (gamma, beta))
    w1, b1 = _lin(rng, DIM, MLP)
    w2, b2 = _lin(rng, MLP, DIM)
    w1j, w1t = _pair(w1, jdt, tdt, grad=False)
    w2j, w2t = _pair(w2, jdt, tdt, grad=False)
    w1t = w1t.t().contiguous().requires_grad_(True)
    w2t = w2t.t().contiguous().requires_grad_(True)
    (b1j, b1t), (b2j, b2t) = (_pair(a, jnp.float32, torch.float32)
                              for a in (b1, b2))
    cj, ct = _pair(rng.standard_normal((M, DIM)), jdt, tdt, grad=False)
    seed = jnp.zeros((1, 1), jnp.int32)
    out, grads = _vjp(lambda *a: jmlp._fused(*a, seed, 0.0),
                      (xj, gj, bej, w1j, b1j, w2j, b2j), cj)
    (y,), tgrads = _run_torch(
        lambda x, *p: fused_mlp_block(x.reshape(B, N, DIM), *p).reshape(M, DIM),
        (xt, gt, bet, w1t, b1t, w2t, b2t), ct)
    _close(y, out, dtype)
    for i, (g, w_) in enumerate(zip(tgrads, grads)):
        _close(g.t() if i in (3, 5) else g, w_, dtype)


# --- dropout 0.1: the hand-written backward against finite differences -----

def _directional_check(fn, inputs, seed):
    """<grad f, d> against (f(x + e d) - f(x - e d)) / 2e for f = sum(out *
    cot), one random direction d per input, masks fixed by the seeds."""
    rng = np.random.default_rng(seed)
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
            for o in outs]
    torch.autograd.backward(outs, cots)
    eps = 1e-2

    def f(xs):
        with torch.no_grad():
            o = fn(*xs)
            o = o if isinstance(o, tuple) else (o,)
            return sum(float((a.double() * c.double()).sum())
                       for a, c in zip(o, cots))

    for i, t in enumerate(inputs):
        d = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
        plus = [x.detach() + (eps * d if j == i else 0)
                for j, x in enumerate(inputs)]
        minus = [x.detach() - (eps * d if j == i else 0)
                 for j, x in enumerate(inputs)]
        fd = (f(plus) - f(minus)) / (2 * eps)
        an = float((t.grad.double() * d.double()).sum())
        assert abs(fd - an) <= 2e-2 * max(abs(an), 1e-3), (i, fd, an)


def test_dropout_backwards_match_finite_differences():
    rng = np.random.default_rng(5)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    q, k, v = (t(1, 33, 2, 16) for _ in range(3))
    _directional_check(lambda q, k, v: flash_attention(
        q, k, v, scale=0.25, n_valid=30, dropout_rate=0.1, seed=11),
        (q, k, v), 1)
    x, g, b = t(1, 17, DIM), 1 + t(DIM, scale=0.1), t(DIM, scale=0.1)
    _directional_check(lambda x, a, w, bo: fused_outproj_residual(
        x, a, w, bo, dropout_rate=0.1, seed=12),
        (x, t(1, 17, INNER), t(DIM, INNER, scale=0.1), t(DIM, scale=0.1)), 2)
    _directional_check(lambda *a: fused_mlp_block(
        *a, dropout_rate=0.1, seeds=(13, 14)),
        (x, g, b, t(MLP, DIM, scale=0.1), t(MLP, scale=0.1),
         t(DIM, MLP, scale=0.1), t(DIM, scale=0.1)), 3)
    _directional_check(lambda x, g, b, w: fused_ln_qkv(x, g, b, w, 2, 16),
                       (x, g, b, t(96, DIM, scale=0.1)), 4)
