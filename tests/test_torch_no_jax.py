"""The port stands without JAX, builds its kernels only on demand, and its
CPU path never counts a kernel launch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.ops import _build
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                    int8_serving)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTED = (fa.flash_attention_cuda, fused_qkv.fused_ln_qkv_cuda,
           fused_outproj.fused_outproj_residual_cuda,
           fused_mlp.fused_mlp_block_cuda, fa.flash_attention_bwd_cuda,
           fused_qkv.fused_ln_qkv_bwd_cuda, fused_outproj.fused_outproj_bwd_cuda,
           fused_mlp.fused_mlp_bwd_cuda, int8_serving.int8_ln_qkv_cuda,
           int8_serving.int8_outproj_residual_cuda,
           int8_serving.int8_mlp_block_cuda,
           int8_serving.int8_flash_attention_cuda)


def test_every_module_imports_with_jax_blocked():
    script = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import neurovit_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not [m for m in sys.modules if m.startswith('jax.')]\n"
        "assert 'neurovit_tpu_torch.ops.int8_serving' in names\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cpu_path_launches_no_kernel():
    before = [fn.launches for fn in COUNTED]
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = t(1, 5, 2, 8), t(1, 5, 2, 8), t(1, 5, 2, 8)
    x = t(1, 5, 16)
    fa.flash_attention(q, k, v, scale=0.3)
    fused_qkv.fused_ln_qkv(x, t(16), t(16), t(48, 16), 2, 8)
    fused_outproj.fused_outproj_residual(x, t(1, 5, 16), t(16, 16), t(16))
    fused_mlp.fused_mlp_block(x, t(16), t(16), t(32, 16), t(32), t(16, 32),
                              t(16))
    # Forward and backward with dropout, through the autograd functions.
    params = [p.requires_grad_() for p in (t(16), t(16), t(48, 16))]
    q, k, v = fused_qkv.fused_ln_qkv(x, *params, 2, 8)
    o = fa.flash_attention(q, k, v, scale=0.3, dropout_rate=0.1, seed=1)
    y = fused_outproj.fused_outproj_residual(
        x, o.reshape(1, 5, 16), t(16, 16), t(16), dropout_rate=0.1, seed=2)
    y = fused_mlp.fused_mlp_block(y, t(16), t(16), t(32, 16), t(32),
                                  t(16, 32), t(16), dropout_rate=0.1,
                                  seeds=(3, 4))
    y.sum().backward()
    assert all(p.grad is not None for p in params)
    # The int8 serving ops.
    w8, s = int8_serving.quantize_weight(t(48, 16))
    q, k, v = int8_serving.int8_ln_qkv(x, t(16), t(16), w8, s, 2, 8)
    o = int8_serving.int8_flash_attention(q, k, v, scale=0.3, n_valid=4)
    w8, s = int8_serving.quantize_weight(t(16, 16))
    int8_serving.int8_outproj_residual(x, o.reshape(1, 5, 16), w8, s, t(16))
    (w1, s1), (w2, s2) = (int8_serving.quantize_weight(t(32, 16)),
                          int8_serving.quantize_weight(t(16, 32)))
    int8_serving.int8_mlp_block(x, t(16), t(16), w1, s1, t(32), w2, s2, t(16))
    assert [fn.launches for fn in COUNTED] == before == [0] * 12


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers check their operands before any build or launch."""
    x = torch.zeros(1, 5, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_outproj.fused_outproj_residual_cuda(
            x, torch.zeros(1, 5, 16, dtype=torch.bfloat16),
            torch.zeros(16, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(*(torch.zeros(1, 5, 2, 64) for _ in range(3)),
                                scale=0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_serving.int8_flash_attention_cuda(
            *(torch.zeros(1, 5, 2, 64) for _ in range(3)), scale=0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_serving.int8_outproj_residual_cuda(
            x, x, torch.zeros(16, 16, dtype=torch.int8), torch.ones(16),
            torch.zeros(16))
