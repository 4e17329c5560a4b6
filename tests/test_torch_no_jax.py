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
                                    int8_gemm, int8_serving, maxpool3d,
                                    tp_forms)

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
           int8_gemm.dynquant_matmul_cuda, fa.flash_attention_f32_cuda,
           fused_qkv.fused_ln_qkv_f32_cuda,
           fused_outproj.fused_outproj_residual_f32_cuda,
           fused_mlp.fused_mlp_block_f32_cuda,
           int8_serving.int8_ln_qkv_f32_cuda,
           int8_serving.int8_outproj_residual_f32_cuda,
           int8_serving.int8_mlp_block_f32_cuda,
           int8_serving.int8_flash_attention_f32_cuda,
           fa.flash_attention_bhnd_f32_cuda,
           fa.flash_attention_bhnd_bwd_f32_cuda,
           *tp_forms.CUDA_WRAPPERS.values())


def test_every_module_imports_with_jax_blocked():
    """With ``jax`` and ``neurovit_tpu`` both blocked: every module of the
    port imports (the sweep and the profiler among them, each called once),
    the config loads, the data layer batches the synthetic
    cube dataset, a small ResNet runs forward and backward, the two probe
    scripts (scripts/torch_dropout_bench.py and
    scripts/torch_int8_gemm_bench.py) run their plain paths at a tiny size,
    scripts/torch_gemm_device_times.py refuses to run without the card, and
    the 2D CAM tutorial's CLI trains a step and writes its PNG on the CPU;
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
        "for mod in ('mesh', 'distributed', 'sharding', "
        "'tensor_parallel'):\n"
        "    assert f'neurovit_tpu_torch.parallel.{mod}' in names, mod\n"
        "assert 'neurovit_tpu_torch.ops.tp_forms' in names\n"
        "assert 'neurovit_tpu_torch.dryrun' in names\n"
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
        "from neurovit_tpu_torch.explainability import vit_cam_2d\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    png = vit_cam_2d.main(['--steps', '1', '--device', 'cpu',\n"
        "                           '--output-dir', d])\n"
        "    assert open(png, 'rb').read(8) == b'\\x89PNG\\r\\n\\x1a\\n'\n"
        "assert 'neurovit_tpu_torch.explainability.vit_cam_2d' in names\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_parallel_runs_with_jax_blocked(tmp_path):
    """With ``jax`` and ``neurovit_tpu`` blocked: a one-rank gloo group
    from the DISTRIBUTED_* keys, a data-parallel ResNet train step through
    the global BatchNorm and the gradient reduction, and a two-replica
    Predictor; no module of either was loaded."""
    script = (
        "import socket, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neurovit_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from neurovit_tpu_torch.config import load_config\n"
        "from neurovit_tpu_torch.models import NeuroEncoder\n"
        "from neurovit_tpu_torch.parallel import create_mesh, distributed\n"
        "from neurovit_tpu_torch.serving import Predictor\n"
        "from neurovit_tpu_torch.training import Trainer\n"
        "s = socket.socket(); s.bind(('localhost', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        f"config = load_config(overrides={{'TRAINING_VIT_INPUT_SIZE': 16,\n"
        "    'TRAINING_VIT_PATCH_SIZE': 4, 'DATASET_NAME': 'adni',\n"
        "    'MODEL_VOLUME_ENCODER': 'resnet', 'MODEL_RESNET_DEPTH': 10,\n"
        "    'TRAINING_PRECISION': 'f32', 'TRAINING_BATCH_SIZE': 2,\n"
        f"    'GLOBAL_OUTPUT_DIR': {str(tmp_path)!r},\n"
        "    'DISTRIBUTED_MULTIHOST': True,\n"
        "    'DISTRIBUTED_COORDINATOR': f'localhost:{port}',\n"
        "    'DISTRIBUTED_NUM_PROCESSES': 1, 'DISTRIBUTED_PROCESS_ID': 0})\n"
        "assert distributed.maybe_initialize(config, torch.device('cpu'))\n"
        "class Vols:\n"
        "    def __len__(self): return 4\n"
        "    def sample(self, i):\n"
        "        return {'volume': np.zeros((16, 16, 16), np.float32),\n"
        "                'label': i % 2}\n"
        "model = NeuroEncoder(config, device='cpu')\n"
        "trainer = Trainer(config, model, Vols(), Vols())\n"
        "assert trainer.mesh.distributed\n"
        "x = torch.randn(2, 16, 16, 16)\n"
        "m = trainer.train_step({'volume': x, 'label': torch.tensor([0, 1]),\n"
        "                        'valid': torch.tensor([True, True])})\n"
        "assert int(m['count']) == 2 and torch.isfinite(m['loss'])\n"
        "p = Predictor(model, batch_size=2, devices=['cpu', 'cpu'])\n"
        "assert p(x.numpy())[1].shape == (2, 2)\n"
        "distributed.shutdown()\n"
        "loaded = [m for m in sys.modules if m == 'jax' or m == "
        "'neurovit_tpu' or m.startswith(('jax.', 'neurovit_tpu.'))]\n"
        "assert not [m for m in loaded if sys.modules[m] is not None], "
        "loaded\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_tensor_parallel_runs_with_jax_blocked():
    """With ``jax`` and ``neurovit_tpu`` blocked: a tensor-parallel
    replica over two CPU copies serves a small ViT (bf16, f32 and int8) as
    one replica does, and ``dryrun_multichip(2)`` (two gloo ranks, tp 2)
    passes its parts; no module of either was loaded."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neurovit_tpu'] = None\n"
        "import copy, torch\n"
        "from neurovit_tpu_torch.models.vit3d import (ViT3D, ViTConfig,\n"
        "                                             quantize_blocks)\n"
        "from neurovit_tpu_torch.parallel.tensor_parallel import (\n"
        "    TensorParallelViT)\n"
        "cfg = ViTConfig(image_size=10, image_patch_size=5, frames=10,\n"
        "    frame_patch_size=5, num_classes=2, dim=32, depth=2, heads=2,\n"
        "    dim_head=16, mlp_dim=64)\n"
        "vit = ViT3D(cfg)\n"
        "vit.reset_parameters(torch.Generator().manual_seed(0))\n"
        "x = torch.randn(2, 1, 10, 10, 10)\n"
        "with torch.no_grad():\n"
        "    for v, dt in ((vit, torch.float32), (vit, torch.bfloat16),\n"
        "                  (quantize_blocks(copy.deepcopy(vit)),\n"
        "                   torch.float32)):\n"
        "        want = v(x.to(dt))\n"
        "        got = TensorParallelViT(v, ['cpu', 'cpu'])(x.to(dt))\n"
        "        assert (got - want).abs().max() < 1e-3, (got, want)\n"
        "from neurovit_tpu_torch.dryrun import dryrun_multichip\n"
        "dryrun_multichip(2, device='cpu')\n"
        "loaded = [m for m in sys.modules if m == 'jax' or m == "
        "'neurovit_tpu' or m.startswith(('jax.', 'neurovit_tpu.'))]\n"
        "assert not [m for m in loaded if sys.modules[m] is not None], "
        "loaded\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "dryrun_multichip(2): 3D mesh={'data': 1, 'model': 2" in out.stdout
    assert out.stdout.split()[-1] == "ok"


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
    # The 2D CAM tutorial: an f32 ViT's train step, a gradient CAM (K6 f32
    # forward and backward) and a forward-only one.
    from neurovit_tpu_torch.explainability import vit_cam_2d
    model2d = vit_cam_2d.ViT2D(device="cpu")
    squares = vit_cam_2d.make_squares(8, generator=torch.Generator()
                                      .manual_seed(0))
    vit_cam_2d.train_demo_model(model2d, steps=1, batch=4, verbose=False,
                                data=squares)
    for method in ("gradcam", "scorecam"):
        cam, _ = vit_cam_2d.compute_cam_2d(model2d, squares[0][0],
                                           method=method, score_batch=64)
        assert cam.shape == (vit_cam_2d.IMAGE_SIZE,) * 2
    # The tensor-parallel forms' plain versions.
    y = tp_forms.outproj_partial(x, t(1, 5, 8), t(16, 8), t(16), first=True)
    y, h = tp_forms.mlp_partial(x, t(16), t(16), t(16, 16), t(16),
                                t(16, 16), t(16), first=False, return_h=True)
    tp_forms.mlp_bwd_partial(t(1, 5, 16), x, h, t(16), t(16), t(16, 16),
                             t(16, 16), first=True)
    tp_forms.ln_qkv_bwd_partial(t(1, 5, 24), x, t(16), t(24, 16))
    amax = tp_forms.int8_row_amax(t(1, 5, 8))
    w8, s = int8_serving.quantize_weight(t(16, 8))
    acc = tp_forms.int8_outproj_partial(t(1, 5, 8), amax, w8)
    tp_forms.int8_dequant_residual(x, acc, amax, s, t(16))
    assert [fn.launches for fn in COUNTED] == before == [0] * 46


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
