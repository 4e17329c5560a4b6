"""K17 and K18, the GEMM probes of ``scripts/int8_pallas_bench.py``: the
port's plain versions (``neurovit_tpu_torch.ops.int8_gemm``) against the
script's ``blocked_matmul`` and ``dynquant_matmul`` run in interpret mode
(the script loaded by path), at [512, 256] x [256, 256] and at the N = 64
edge of the attention PV shape.

int8 products are exact on both sides, and K18's epilogue rounds at the
same points, so those compare bit for bit. The bf16 product sums f32 in
another order: |diff| <= 2^-20 sum_k |a||b| elementwise.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neurovit_tpu_torch.ops import int8_gemm as g

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "int8_pallas_bench", os.path.join(REPO, "scripts",
                                          "int8_pallas_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sa = (rng.random((m, 1)) + 0.5).astype(np.float32)
    sb = (rng.random((1, n)) + 0.5).astype(np.float32)
    abf = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    bbf = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    return a8, b8, sa, sb, abf, bbf


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("m,k,n", [(512, 256, 256), (512, 256, 64)])
def test_plain_matches_pallas_interpret(probe, m, k, n):
    a8, b8, sa, sb, abf, bbf = _operands(m, k, n, m + n)
    with pltpu.force_tpu_interpret_mode():
        c8 = probe.blocked_matmul(jnp.asarray(a8), jnp.asarray(b8),
                                  acc_dtype=jnp.int32)
        dq = probe.dynquant_matmul(jnp.asarray(a8), jnp.asarray(b8),
                                   jnp.asarray(sa), jnp.asarray(sb))
        cbf = probe.blocked_matmul(abf, bbf, acc_dtype=jnp.float32)

    got8 = g.blocked_matmul(_t(a8), _t(b8))
    assert got8.dtype == torch.int32
    np.testing.assert_array_equal(got8.numpy(), np.asarray(c8))
    np.testing.assert_array_equal(
        got8.numpy().astype(np.int64),
        a8.astype(np.int64) @ b8.astype(np.int64))

    got_dq = g.dynquant_matmul(_t(a8), _t(b8), _t(sa), _t(sb))
    assert got_dq.dtype == torch.bfloat16 and got_dq.shape == (m, n)
    np.testing.assert_array_equal(got_dq.float().numpy(),
                                  np.asarray(dq.astype(jnp.float32)))

    a = _t(abf.astype(jnp.float32)).to(torch.bfloat16)
    b = _t(bbf.astype(jnp.float32)).to(torch.bfloat16)
    got = g.blocked_matmul(a, b)
    assert got.dtype == torch.float32
    bound = 2.0 ** -20 * (a.float().abs() @ b.float().abs()).numpy()
    assert (np.abs(got.numpy() - np.asarray(cbf)) <= bound).all()


def test_plain_versions_on_small_shapes():
    """The epilogue order (acc * sa) * sb, each product rounded in f32, and
    the scale shapes [M, 1] / [1, N] or flat."""
    a8 = torch.tensor([[127, -127], [3, 5]], dtype=torch.int8)
    b8 = torch.tensor([[127, 1], [-127, 2]], dtype=torch.int8)
    acc = g.blocked_matmul_plain(a8, b8)
    assert acc.tolist() == [[32258, -127], [-254, 13]]
    sa, sb = torch.tensor([0.1, 3.0]), torch.tensor([7.0, 1e-3])
    want = ((acc.float() * sa[:, None]) * sb[None, :]).to(torch.bfloat16)
    assert torch.equal(g.dynquant_matmul_plain(a8, b8, sa, sb), want)
    assert torch.equal(g.dynquant_matmul_plain(a8, b8, sa[:, None],
                                               sb[None, :]), want)
