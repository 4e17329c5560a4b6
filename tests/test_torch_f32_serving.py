"""The f32 paths that the f32 forwards K1-K4 open on the card, as far as the
CPU reaches them: the f32 ``Predictor`` against the JAX ``Predictor`` on
its Pallas kernels (interpret mode) with weights carried by
``from_jax_params``; the f32 runs the trainer takes on CUDA (the 4D model,
its int8 encoder, which K10-K13's f32 instances run, and the 3D ViT);
Grad-CAM, integrated gradients, grad x input, int8 serving and the 2D CAM
tutorial of an f32 ViT, with the ops taken as on the card, reaching the
f32 kernels (K6 f32 among them) and no bf16 one; and the model's own f32
products (patch embedding, head, temporal head) at full f32 whatever the
caller set.

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


def _as_on_card(monkeypatch):
    """The ops taken as on the card: their dispatch sees CUDA operands, the
    operand checks pass, and each launch is recorded (its entry point's
    name) in place of running, the outputs left as allocated (zeros here).
    The wrappers' launch counters are restored after the test."""
    from neurovit_tpu_torch.ops import (common, fused_mlp, fused_outproj,
                                        fused_qkv, int8_serving, tf32x3)
    from neurovit_tpu_torch.ops import flash_attention as fa

    seen = []
    for mod in (common, fa, fused_qkv, fused_outproj, fused_mlp,
                int8_serving, tf32x3):
        for name, value in (
                ("on_cpu", lambda *_: False),
                ("check_operand", lambda *a, **k: None),
                ("launch", lambda symbol, *a: seen.append(symbol))):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
        for fn in list(vars(mod).values()):
            if callable(fn) and hasattr(fn, "launches"):
                monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(torch, "empty", torch.zeros)
    monkeypatch.setattr(torch, "empty_like", torch.zeros_like)
    return seen


K6_F32 = ["nvt_flash_attention_bhnd_f32_fwd",
          "nvt_flash_attention_bhnd_f32_bwd"]
F32_FORWARDS = ["nvt_fused_ln_qkv_f32_fwd", "nvt_flash_attention_f32_fwd",
                "nvt_fused_outproj_f32_fwd", "nvt_fused_mlp_f32_fwd",
                "nvt_split_f32"]
F32_BACKWARDS = ["nvt_fused_ln_qkv_f32_bwd", "nvt_flash_attention_f32_bwd",
                 "nvt_fused_outproj_f32_bwd", "nvt_fused_mlp_f32_bwd",
                 "nvt_wsplit_f32"]
INT8_F32 = ["nvt_int8_ln_qkv_f32", "nvt_int8_attention_f32",
            "nvt_int8_outproj_f32", "nvt_int8_mlp_f32"]


@pytest.mark.parametrize("entry", ["gradcam", "menu", "ig", "grad_x_input",
                                   "int8", "vit_cam_2d"])
def test_f32_on_cuda_refused_at_the_entry_point(monkeypatch, entry):
    """Nothing is refused for an f32 ViT on the card: Grad-CAM
    (get_attention_map and the menu), integrated gradients, grad x input,
    int8 serving and the 2D CAM tutorial, with the ops taken as on the
    card, reach the f32 kernels and no bf16 one. A probe runs K6 at f32
    once forward and once backward (the last block) beside K1-K4 f32 (K2's
    and K4's weight pre-pass with them) and K9 f32 (the last block's MLP
    under the gradient, with its transposing weight pre-pass); IG and grad
    x input differentiate the volume through every block (K1-K5, K7-K9 f32
    and the backwards' weight pre-pass, no K6); int8 serving runs K10-K13
    f32."""
    from neurovit_tpu_torch.explainability import vit_cam_2d
    from neurovit_tpu_torch.explainability.cam_methods import compute_cam

    seen = _as_on_card(monkeypatch)
    model = NeuroEncoder(_config(), device="cpu", seed=1)
    x = _vols(0, 1)[0]
    calls = {
        "gradcam": lambda: model.get_attention_map(x),
        "menu": lambda: compute_cam(model, x, method="gradcam"),
        "ig": lambda: integrated_gradients.integrated_gradients(model, x,
                                                                steps=2),
        "grad_x_input": lambda: bcos.explain(model, x),
        "int8": lambda: Predictor(model, batch_size=2, quant="int8")(
            _vols(1, 2)),
    }
    if entry == "vit_cam_2d":
        model2d = vit_cam_2d.ViT2D(device="cpu")
        vit_cam_2d.compute_cam_2d(model2d, np.zeros((56, 56), np.float32))
    else:
        calls[entry]()
    assert seen and all("_f32" in symbol for symbol in seen), seen
    if entry in ("gradcam", "menu", "vit_cam_2d"):
        assert [seen.count(s) for s in K6_F32] == [1, 1]
        assert set(seen) == set(K6_F32 + F32_FORWARDS
                                + ["nvt_fused_mlp_f32_bwd", "nvt_wsplit_f32"])
    elif entry == "int8":
        assert set(seen) == set(INT8_F32)
    else:
        assert set(seen) == set(F32_FORWARDS + F32_BACKWARDS)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_bf16_on_cuda_and_f32_on_cpu_are_not_refused(monkeypatch,
                                                     precision):
    """A bf16 ViT's Grad-CAM taken as on the card reaches the bf16 K6 (and
    no f32 kernel); an f32 ViT's on the CPU runs the plain versions,
    launching nothing, and its map is finite."""
    model = NeuroEncoder(_config(TRAINING_PRECISION=precision),
                         device="cpu", seed=1)
    x = _vols(2, 1)[0]
    if precision == "f32":
        cam, _ = model.get_attention_map(x)
        assert cam.shape == (20, 20, 20) and np.isfinite(cam).all()
        return
    seen = _as_on_card(monkeypatch)
    model.get_attention_map(x)
    assert seen and not [s for s in seen if "_f32" in s], seen
    assert [seen.count("nvt_flash_attention_bhnd_fwd"),
            seen.count("nvt_flash_attention_bhnd_bwd")] == [1, 1]


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
