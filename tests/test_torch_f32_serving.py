"""The f32 paths that the f32 forwards K1-K4 open on the card, as far as the
CPU reaches them: the f32 ``Predictor`` against the JAX ``Predictor`` on
its Pallas kernels (interpret mode) with weights carried by
``from_jax_params``; the f32 runs the trainer takes on CUDA (the 4D model,
its int8 encoder, which K10-K13's f32 instances run, and the 3D ViT);
Grad-CAM, integrated gradients and grad x input of an f32 ViT on CUDA
refused at their entry points before any op runs, and int8 serving of it
built there; and the model's own f32 products (patch embedding, head,
temporal head) at full f32 whatever the caller set.

Tolerance against JAX: rtol = atol = 1e-4 (f32 sums taken in another
order, as tests/test_torch_ops.py).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.config import load_config as jax_load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.serving import Predictor as JaxPredictor
from neurovit_tpu_torch import nn
from neurovit_tpu_torch.config import load_config
from neurovit_tpu_torch.explainability import bcos, integrated_gradients
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models import vit3d
from neurovit_tpu_torch.serving import Predictor
from neurovit_tpu_torch.training.state_dict import from_jax_params
from neurovit_tpu_torch.training.trainer import check_supported

torch.set_num_threads(1)

TINY = {"TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "TRAINING_DROPOUT": 0.0, "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "KERNEL_IMPL": "pallas",
        "WANDB_ENABLED": False}


def _vols(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


@pytest.mark.parametrize("heads,dim_head", [(4, 16), (2, 32)])
def test_f32_predictor_matches_jax_pallas(heads, dim_head):
    """The f32 Predictor (CPU plain path) against the JAX Predictor whose
    blocks run the Pallas kernels at f32, on the same weights."""
    overrides = dict(TINY, MODEL_VIT_HEADS=heads, MODEL_VIT_DIM_HEAD=dim_head)
    jconfig = jax_load_config(overrides=overrides)
    jmodel = JaxNeuroEncoder(jconfig)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5)))
    model = NeuroEncoder(load_config(overrides=overrides), device="cpu",
                         seed=6)
    model.load_state_dict(from_jax_params(variables["params"]), strict=True)
    vols = _vols(heads, 5)
    want_labels, want = JaxPredictor(jmodel, variables, batch_size=4)(vols)
    labels, got = Predictor(model, batch_size=4)(vols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(labels, want_labels)


def _config(**extra):
    return load_config(overrides={**TINY, **extra})


@pytest.mark.parametrize("extra", [
    {"TRAINING_DIM": 4},
    {"TRAINING_DIM": 4, "TRAINING_PRECISION": "bf16"},
    {"TRAINING_DIM": 3},
    {"TRAINING_DIM": 3, "TRAINING_PRECISION": "bf16"},
    {"TRAINING_DIM": 4, "TRAINING_4D_ENCODER_QUANT": "int8"},
    {"TRAINING_DIM": 4, "TRAINING_4D_ENCODER_QUANT": "int8",
     "TRAINING_PRECISION": "bf16"},
])
def test_check_supported_at_f32_on_cuda(extra):
    """On CUDA the trainer takes an f32 4D model (its frozen ViT runs
    forward only), its int8 encoder at f32 (K10-K13 have f32 instances)
    and the f32 3D ViT (the backwards have f32 instances), as on the
    CPU."""
    config = _config(**extra)
    for device in ("cpu", "cuda"):
        check_supported(config, torch.device(device))


@pytest.fixture
def f32_model_on_cuda(monkeypatch):
    """A tiny f32 ViT that reports its parameters on CUDA, with every op
    of its blocks replaced by one that fails the test if it runs."""
    model = NeuroEncoder(_config(), device="cpu", seed=1)
    monkeypatch.setattr(NeuroEncoder, "device",
                        property(lambda self: torch.device("cuda")))

    def ran(*args, **kwargs):
        raise AssertionError("an op of the blocks ran before the refusal")

    for name in ("fused_ln_qkv", "flash_attention", "fused_outproj_residual",
                 "fused_mlp_block", "sdpa", "int8_ln_qkv",
                 "int8_flash_attention", "int8_outproj_residual",
                 "int8_mlp_block", "quantize_weight"):
        monkeypatch.setattr(vit3d, name, ran)
    return model


@pytest.mark.parametrize("entry", ["gradcam", "menu", "ig", "grad_x_input",
                                   "int8"])
def test_f32_on_cuda_refused_at_the_entry_point(f32_model_on_cuda,
                                                monkeypatch, entry):
    """Grad-CAM (get_attention_map and the menu), integrated gradients and
    grad x input of an f32 ViT on CUDA raise not_ported ("f32 on CUDA")
    before any op of the blocks runs. int8 serving of it is not refused
    (K10-K13 have f32 instances): Predictor(quant="int8") builds,
    quantizing the blocks and running none of their ops."""
    from neurovit_tpu_torch.explainability.cam_methods import compute_cam
    from neurovit_tpu_torch.ops.int8_serving import quantize_weight

    model = f32_model_on_cuda
    x = _vols(0, 1)[0]
    if entry == "int8":
        monkeypatch.setattr(vit3d, "quantize_weight", quantize_weight)
        predictor = Predictor(model, batch_size=2, quant="int8")
        assert predictor.quant == "int8"
        assert model.volume_encoder.vit3d.quantized
        return
    calls = {
        "gradcam": lambda: model.get_attention_map(x),
        "menu": lambda: compute_cam(model, x, method="gradcam"),
        "ig": lambda: integrated_gradients.integrated_gradients(model, x,
                                                                steps=2),
        "grad_x_input": lambda: bcos.explain(model, x),
    }
    with pytest.raises(NotImplementedError, match="Queue 1: f32 on CUDA"):
        calls[entry]()


def test_bf16_on_cuda_and_f32_on_cpu_are_not_refused(monkeypatch):
    """The refusal is for f32 on CUDA only: a bf16 ViT reporting CUDA and
    an f32 ViT on the CPU pass it."""
    f32 = NeuroEncoder(_config(), device="cpu", seed=1)
    f32.refuse_f32_on_cuda("anything")
    bf16 = NeuroEncoder(_config(TRAINING_PRECISION="bf16"), device="cpu",
                        seed=1)
    monkeypatch.setattr(NeuroEncoder, "device",
                        property(lambda self: torch.device("cuda")))
    bf16.refuse_f32_on_cuda("anything")
    with pytest.raises(NotImplementedError, match="anything of an f32 ViT"):
        f32.refuse_f32_on_cuda("anything")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_model_products_at_full_f32(monkeypatch, precision):
    """The f32 ViT's own products (patch embedding, head) and the 4D
    temporal head's run at "highest" precision though the caller set
    "high" (TF32 on the card), which holds again after; in bf16 the
    setting is left as it is."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args, **kwargs)

    model = NeuroEncoder(_config(TRAINING_DIM=4, TRAINING_PRECISION=precision,
                                 MODEL_TEMPORAL_DROPOUT=0.0),
                         device="cpu", seed=2)
    seq = torch.from_numpy(_vols(3, 2).transpose(1, 2, 3, 0)[None].copy())
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        with torch.no_grad():
            logits = model(seq)
        monkeypatch.setattr(torch, "matmul", matmul)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert logits.shape == (1, 2) and torch.isfinite(logits).all()
    want = "highest" if precision == "f32" else "high"
    assert seen and set(seen) == {want}


def test_full_f32_restores_on_error():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with pytest.raises(RuntimeError):
            with nn.full_f32(torch.float32):
                assert torch.get_float32_matmul_precision() == "highest"
                raise RuntimeError
        assert torch.get_float32_matmul_precision() == "medium"
        with nn.full_f32(torch.bfloat16):
            assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_f32_4d_model_on_cpu_deep_copy_keeps_f32():
    """An f32 4D model's encodings come from its f32 ViT (the frozen
    encoder's dtype follows TRAINING_PRECISION), and a deep copy, as the
    trainer's int8 path makes, encodes the same."""
    model = NeuroEncoder(_config(TRAINING_DIM=4), device="cpu", seed=4)
    assert model.compute_dtype == torch.float32
    seq = torch.from_numpy(_vols(5, 3).transpose(1, 2, 3, 0)[None].copy())
    enc = model.encode_sequence(seq)
    assert enc.dtype == torch.float32 and enc.shape == (1, 3, 2)
    twin = copy.deepcopy(model)
    torch.testing.assert_close(twin.encode_sequence(seq), enc, rtol=0,
                               atol=0)


class _Series:
    """Two [20, 20, 20, 2] series made from the index."""

    def __len__(self):
        return 2

    def sample(self, idx):
        vol = np.random.default_rng(idx).standard_normal(
            (20, 20, 20, 2)).astype(np.float32)
        return {"volume": vol, "label": idx % 2, "subject": f"s{idx}",
                "timepoint": 0}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_train_step_products_at_full_f32(monkeypatch, tmp_path, precision):
    """A 4D train step of an f32 model runs at "highest" precision from its
    forward through its backward (the logits' and the temporal head's
    gradients) to the optimizer step, though the caller set "high", which
    holds again after; at bf16 the setting is left as it is."""
    from neurovit_tpu_torch.training import Trainer

    config = _config(TRAINING_DIM=4, TRAINING_PRECISION=precision,
                     MODEL_TEMPORAL_DROPOUT=0.0, TRAINING_BATCH_SIZE=2,
                     TRAINING_NUM_WORKERS=0,
                     GLOBAL_OUTPUT_DIR=str(tmp_path / "runs"))
    model = NeuroEncoder(config, device="cpu", seed=3)
    trainer = Trainer(config, model, _Series(), _Series())
    seen = {"forward": [], "backward": [], "step": []}
    matmul, step = torch.matmul, trainer.optimizer.step

    def spy(*args, **kwargs):
        seen["forward"].append(torch.get_float32_matmul_precision())
        return matmul(*args, **kwargs)

    def stepped(*args, **kwargs):
        seen["step"].append(torch.get_float32_matmul_precision())
        return step(*args, **kwargs)

    def in_backward(grad):
        seen["backward"].append(torch.get_float32_matmul_precision())
        return grad

    for p in model.parameters():
        if p.requires_grad:
            p.register_hook(in_backward)
    vols = np.stack([_Series().sample(i)["volume"] for i in range(2)])
    batch = {"volume": torch.from_numpy(vols),
             "label": torch.tensor([0, 1]),
             "valid": torch.tensor([True, True])}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        monkeypatch.setattr(trainer.optimizer, "step", stepped)
        out = trainer.train_step(batch)
        monkeypatch.setattr(torch, "matmul", matmul)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.isfinite(out["loss"])
    want = "highest" if precision == "f32" else "high"
    for part, got in seen.items():
        assert got and set(got) == {want}, part
