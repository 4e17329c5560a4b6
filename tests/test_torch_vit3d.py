"""The port's NeuroEncoder forward (plain PyTorch on the CPU) against the
JAX NeuroEncoder on the same weights and volumes, at a tiny 3D ViT:
grid 20, patch 5, dim 64, depth 2, 4 heads of 16, MLP 128.

The JAX side runs both of its impls: ``pallas`` (the Pallas kernels in
interpret mode, on the lane-padded token stream) and ``xla``. Tolerances:
f32 rtol = atol = 1e-3; bf16 atol 5e-2 (the same rounding points; f32 sums
in another order move a bf16 value by at most an ulp now and then, and the
difference passes through two blocks).
"""

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.config import load_config
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.training import state_dict as jax_state_dict
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import ViTConfig, patchify
from neurovit_tpu_torch.training.checkpoint import load_checkpoint
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=1e-3, atol=1e-3), "bf16": dict(rtol=0, atol=5e-2)}


def tiny_config(precision="f32", impl="xla", **extra):
    return load_config(overrides={
        "TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": precision,
        "TRAINING_DROPOUT": 0.0, "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2,
        "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "KERNEL_IMPL": impl, **extra})


def _volumes(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 20, 20, 20)).astype(np.float32)


def _jax_logits(model, params, vols):
    logits, _ = model.apply(params, jax.numpy.asarray(vols))
    return np.asarray(logits)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_logits_match_jax(precision, impl):
    config = tiny_config(precision, impl)
    jmodel = JaxNeuroEncoder(config)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3))["params"])
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    vols = _volumes(4)
    with torch.no_grad():
        got = model(torch.from_numpy(vols))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), _jax_logits(jmodel, params, vols),
                               **TOL[precision])


def test_jax_checkpoint_round_trip(tmp_path):
    """JAX to_state_dict -> state_dict.save (torch zip) -> the port's
    load_checkpoint gives the JAX model's logits."""
    config = tiny_config("f32", "xla")
    jmodel = JaxNeuroEncoder(config)
    params = jmodel.init(jax.random.key(5))["params"]
    path = str(tmp_path / "model.state_dict.pkl")
    jax_state_dict.save(path, jax_state_dict.to_state_dict(jmodel, params))

    model = NeuroEncoder(config, device="cpu", seed=123)
    result = load_checkpoint(model, path, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    vols = _volumes(6)
    with torch.no_grad():
        got = model(torch.from_numpy(vols)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jmodel, params, vols),
                               **TOL["f32"])


def test_state_dict_keys_are_the_reference_keys():
    """The port's own state_dict() keys and shapes are exactly the JAX
    export's, so either side's checkpoints load strictly into the other."""
    config = tiny_config()
    jmodel = JaxNeuroEncoder(config)
    exported = jax_state_dict.to_state_dict(
        jmodel, jmodel.init(jax.random.key(0))["params"])
    ours = NeuroEncoder(config, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in exported.items()}


def test_patchify_matches_jax():
    from neurovit_tpu.models import vit3d as jvit

    jcfg = jvit.ViTConfig(image_size=12, image_patch_size=3, frames=8,
                          frame_patch_size=2, num_classes=2, channels=2)
    cfg = ViTConfig(image_size=12, image_patch_size=3, frames=8,
                    frame_patch_size=2, num_classes=2, channels=2)
    vol = np.random.default_rng(1).standard_normal(
        (2, 2, 8, 12, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(vol), cfg).numpy(),
        np.asarray(jvit.patchify(jax.numpy.asarray(vol), jcfg)))


def test_seeded_init_is_deterministic_and_pytorch_distributed():
    config = tiny_config()
    a = NeuroEncoder(config, device="cpu", seed=7).state_dict()
    b = NeuroEncoder(config, device="cpu", seed=7).state_dict()
    c = NeuroEncoder(config, device="cpu", seed=8).state_dict()
    key = "volume_encoder.vit3d.transformer.layers.0.1.net.1.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
    assert float(a[key].abs().max()) <= 64 ** -0.5          # U(+-1/sqrt(in))
    norm = a["volume_encoder.vit3d.transformer.layers.1.0.norm.weight"]
    assert torch.equal(norm, torch.ones_like(norm))


@pytest.mark.parametrize("extra,item", [
    ({"MESH_PIPE_AXIS": 2}, "multi-GPU"),
    ({"MODEL_VIT_PATCH_EMBED": "conv"}, "odds and ends"),
])
def test_unported_paths_name_their_roadmap_item(extra, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1: {item}"):
        NeuroEncoder(tiny_config(**extra), device="cpu")


def test_grad_cam_is_not_ported():
    """Grad-CAM is ported now (ROADMAP.md, Queue 1, item 4): the call that
    raised NotImplementedError gives a map of the volume's shape and the
    class of the volume's logits (tests/test_torch_gradcam.py holds the
    maps to JAX's)."""
    model = NeuroEncoder(tiny_config(), device="cpu")
    vol = _volumes(9, 1)
    cam, class_idx = model.get_attention_map(vol[0])
    assert cam.shape == (20, 20, 20) and np.isfinite(cam).all()
    with torch.no_grad():
        want = model(torch.from_numpy(vol)).argmax(dim=1)
    assert class_idx.tolist() == want.tolist()
