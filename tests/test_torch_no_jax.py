"""The port stands without JAX and without the JAX package (its config and
data layer are its own), builds its kernels only on demand, and its CPU
path never counts a kernel launch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.ops import _build, dropout
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                    int8_gemm, int8_serving, maxpool3d)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTED = (fa.flash_attention_cuda, fused_qkv.fused_ln_qkv_cuda,
           fused_outproj.fused_outproj_residual_cuda,
           fused_mlp.fused_mlp_block_cuda, fa.flash_attention_bwd_cuda,
           fused_qkv.fused_ln_qkv_bwd_cuda, fused_outproj.fused_outproj_bwd_cuda,
           fused_mlp.fused_mlp_bwd_cuda, int8_serving.int8_ln_qkv_cuda,
           int8_serving.int8_outproj_residual_cuda,
           int8_serving.int8_mlp_block_cuda,
           int8_serving.int8_flash_attention_cuda,
           fa.flash_attention_bhnd_cuda, fa.flash_attention_bhnd_bwd_cuda,
           maxpool3d.max_pool3d_argmax_cuda,
           maxpool3d.max_pool3d_argmax_bwd_cuda, dropout.dropout_cuda,
           int8_gemm.gemm_bf16_cuda, int8_gemm.gemm_int8_cuda,
           int8_gemm.dynquant_matmul_cuda)


def test_every_module_imports_with_jax_blocked():
    """With ``jax`` and ``neurovit_tpu`` both blocked: every module of the
    port imports (the sweep and the profiler among them, each called once),
    the config loads, the data layer batches the synthetic
    cube dataset, a small ResNet runs forward and backward, the two probe
    scripts (scripts/torch_dropout_bench.py and
    scripts/torch_int8_gemm_bench.py) run their plain paths at a tiny size,
    and scripts/torch_gemm_device_times.py refuses to run without the card;
    no module of either was loaded."""
    script = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neurovit_tpu'] = None\n"
        "import neurovit_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from neurovit_tpu_torch.config import load_config\n"
        "from neurovit_tpu_torch.data import DataLoader, get_datasets\n"
        "from neurovit_tpu_torch.models import NeuroEncoder\n"
        "config = load_config(overrides={'TRAINING_VIT_INPUT_SIZE': 16,\n"
        "    'TRAINING_VIT_PATCH_SIZE': 4, 'GRADCAM_NUM_SAMPLES': 10,\n"
        "    'GRADCAM_TRAIN_PATH': None, 'GRADCAM_VAL_PATH': None,\n"
        "    'MODEL_VOLUME_ENCODER': 'resnet', 'MODEL_RESNET_DEPTH': 10,\n"
        "    'TRAINING_PRECISION': 'f32', 'DATASET_NAME': 'gradcam'})\n"
        "train, _ = get_datasets(config)\n"
        "batch = next(iter(DataLoader(train, 2, num_workers=1)))\n"
        "import torch\n"
        "model = NeuroEncoder(config, device='cpu')\n"
        "logits = model(torch.from_numpy(batch['volume']), train=True)\n"
        "logits.sum().backward()\n"
        "assert logits.shape == (2, 8)\n"
        "model = NeuroEncoder(dict(config, TRAINING_DIM=4), device='cpu')\n"
        "seq = torch.from_numpy(batch['volume'])[..., None].repeat("
        "1, 1, 1, 1, 3)\n"
        "assert model(seq, train=True, seed=1).shape == (2, 8)\n"
        "loaded = [m for m in sys.modules if m == 'jax' or m == "
        "'neurovit_tpu' or m.startswith(('jax.', 'neurovit_tpu.'))]\n"
        "assert not [m for m in loaded if sys.modules[m] is not None], "
        "loaded\n"
        "assert 'neurovit_tpu_torch.ops.int8_serving' in names\n"
        "assert 'neurovit_tpu_torch.data.loader' in names\n"
        "assert 'neurovit_tpu_torch.explainability.driver_smri' in names\n"
        "assert 'neurovit_tpu_torch.ops.dropout' in names\n"
        "assert 'neurovit_tpu_torch.ops.int8_gemm' in names\n"
        "assert 'neurovit_tpu_torch.models.temporal' in names\n"
        "assert 'neurovit_tpu_torch.training.feature_cache' in names\n"
        "assert 'neurovit_tpu_torch.training.sweep' in names\n"
        "assert 'neurovit_tpu_torch.utils.profiling' in names\n"
        "import numpy as np\n"
        "from neurovit_tpu_torch.training.sweep import tpe_sample\n"
        "params = tpe_sample({'learning_rate': {'min': 1e-5, 'max': 1e-2}},\n"
        "                    [], np.random.RandomState(42), 1.0)\n"
        "assert 1e-5 <= params['learning_rate'] <= 1e-2, params\n"
        "from neurovit_tpu_torch.utils.profiling import StepTimer, trace\n"
        "timer = StepTimer()\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d, trace(d, cuda=False):\n"
        "    timer.mark()\n"
        "    timer.mark(torch.ones(2) * 2)\n"
        "assert timer.summary()['steps'] == 2\n"
        "import importlib.util\n"
        "def script(name):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'scripts/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "res = script('torch_dropout_bench').run('cpu', rows=8, cols=16,\n"
        "                                        iters=1)\n"
        "assert 0 < res['keep fraction'] <= 1, res\n"
        "gemm = script('torch_int8_gemm_bench')\n"
        "row, = gemm.run('cpu', shapes=[('t', 32, 16, 48)], iters=1)\n"
        "assert row['int_mm'] is None and 'dynquant' in gemm.line(row)\n"
        "assert script('torch_gemm_device_times').main([]) == 1\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


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
    # K6 forward and backward, and a Grad-CAM of a small model.
    q, k, v = (t(1, 2, 5, 8).requires_grad_() for _ in range(3))
    fa.flash_attention(q, k, v, scale=0.3, layout="bhnd").sum().backward()
    assert q.grad is not None
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder
    config = load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 10, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "MODEL_VIT_DIM": 16, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": 2, "MODEL_VIT_DIM_HEAD": 8, "MODEL_VIT_MLP_DIM": 32})
    cam, _ = NeuroEncoder(config, device="cpu").get_attention_map(
        rng.standard_normal((10, 10, 10)))
    assert cam.shape == (10, 10, 10)
    # A small ResNet's forward and backward, and its CAM.
    resnet = NeuroEncoder(dict(config, MODEL_VOLUME_ENCODER="resnet",
                               MODEL_RESNET_DEPTH=10), device="cpu")
    resnet(t(2, 16, 16, 16), train=True).sum().backward()
    from neurovit_tpu_torch.explainability.gradcam_resnet import resnet_cam
    cam, _ = resnet_cam(resnet, rng.standard_normal((16, 16, 16)))
    assert cam.shape == (16, 16, 16)
    # A 4D model's train forward and backward, plain and int8 encoders.
    model4d = NeuroEncoder(dict(config, TRAINING_DIM=4), device="cpu")
    model4d(t(2, 10, 10, 10, 3), train=True, seed=1).sum().backward()
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    import copy
    q8 = quantize_blocks(copy.deepcopy(model4d.volume_encoder.vit3d))
    model4d(t(1, 10, 10, 10, 2), encoder=q8)
    # The probes' ops: K16 forward and backward, K17 and K18.
    xd = t(3, 40).requires_grad_()
    dropout.dropout(xd, 0.1, 7).sum().backward()
    a8 = torch.randint(-127, 128, (32, 16), dtype=torch.int8)
    b8 = torch.randint(-127, 128, (16, 48), dtype=torch.int8)
    int8_gemm.blocked_matmul(a8, b8)
    int8_gemm.blocked_matmul(t(32, 16).bfloat16(), t(16, 48).bfloat16())
    int8_gemm.dynquant_matmul(a8, b8, t(32).abs(), t(48).abs())
    assert [fn.launches for fn in COUNTED] == before == [0] * 20


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
        fa.flash_attention_bhnd_cuda(
            *(torch.zeros(1, 2, 5, 64) for _ in range(3)), scale=0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bhnd_bwd_cuda(
            *(torch.zeros(1, 2, 5, 64) for _ in range(5)),
            torch.zeros(1, 2, 5), scale=0.125, n_valid=5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        maxpool3d.max_pool3d_argmax_cuda(torch.zeros(1, 4, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        maxpool3d.max_pool3d_argmax_bwd_cuda(
            torch.zeros(1, 2, 2, 2, 8, dtype=torch.uint8),
            torch.zeros(1, 2, 2, 2, 8), (1, 4, 4, 4, 8), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_serving.int8_flash_attention_cuda(
            *(torch.zeros(1, 5, 2, 64) for _ in range(3)), scale=0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8_serving.int8_outproj_residual_cuda(
            x, x, torch.zeros(16, 16, dtype=torch.int8), torch.ones(16),
            torch.zeros(16))
