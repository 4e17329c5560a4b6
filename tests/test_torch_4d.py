"""The port's 4D NeuroEncoder against the JAX package's, on the same weights
(``from_jax_params``) and seeded numpy sequences, at the tiny ViT (grid 20,
patch 5, dim 64, depth 2, 4 heads of 16, MLP 128), B 2 x T 3-5,
``MODEL_TEMPORAL_DROPOUT: 0``.

Tolerances: logits at f32 within 1e-3, at bf16 within 5e-2 of the largest
magnitude; the ResNet encoder (depth 10) at f32 within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.training import state_dict as jax_sd
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import state_dict as sd
from neurovit_tpu_torch.training.checkpoint import \
    load_pretrained_volume_encoder
from neurovit_tpu_torch.training.optim import Optimizer
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)


def _cfg(tiny, **kw):
    config = dict(tiny)
    config.update({"TRAINING_DIM": 4, "DATASET_NAME": "adni",
                   "TRAINING_DROPOUT": 0.0, "MODEL_TEMPORAL_DROPOUT": 0.0,
                   **kw})
    return config


def _pair(config, seed=0):
    """The JAX model and variables, and the port's model with them."""
    jmodel = JaxNeuroEncoder(config)
    variables = jax.tree.map(np.asarray,
                             jax.jit(jmodel.init)(jax.random.key(seed)))
    model = NeuroEncoder(config, device="cpu", seed=seed + 1)
    tree = (variables if config.get("MODEL_VOLUME_ENCODER") == "resnet"
            else variables["params"])
    model.load_state_dict(from_jax_params(tree), strict=True)
    return jmodel, variables, model


def _sequences(b, t, seed=1, grid=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, grid, grid, grid, t)).astype(np.float32)
    # A bright cube whose place moves with the timepoint, so the frozen
    # encoder's logits differ across T.
    for i in range(t):
        lo = 2 + 2 * i
        x[:, lo:lo + 6, lo:lo + 6, lo:lo + 6, i] += 3.0
    return x


def _close(got, want, precision, atol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=atol, atol=atol)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=5e-2 * max(float(np.abs(want).max()),
                                               1e-6))


@pytest.mark.parametrize("dataset", ["adni", "gradcam"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_4d_forward_matches_jax(tiny_config, precision, dataset):
    """[B, H, W, D, T] -> logits, d_model 2 (adni) and 8 (gradcam's eight
    cube classes at grid 20)."""
    config = _cfg(tiny_config, TRAINING_PRECISION=precision,
                  DATASET_NAME=dataset)
    jmodel, variables, model = _pair(config)
    assert model.is_4d and model.num_classes == jmodel.num_classes
    x = _sequences(2, 4)
    want, _ = jmodel.apply(variables["params"], jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, precision)
    enc, _, _ = jmodel.encode_sequence(variables["params"],
                                       variables["state"], jnp.asarray(x))
    mine = model.encode_sequence(torch.from_numpy(x))
    assert mine.dtype == torch.float32 and mine.shape == enc.shape
    _close(mine.numpy(), enc, precision)
    _close(model.apply_features(mine).detach().numpy(),
           jmodel.apply_features(variables["params"], enc), precision)


def test_time_fold_equals_per_volume_encode(tiny_config):
    """All B·T volumes in one encoder call give each volume's own encoding
    (neuro_encoder.py:188-218), in the port and against JAX."""
    config = _cfg(tiny_config)
    jmodel, variables, model = _pair(config)
    x = _sequences(2, 3, seed=2)
    folded = model.encode_sequence(torch.from_numpy(x))
    for b in range(2):
        for t in range(3):
            with torch.no_grad():
                one = model.encode_volume(torch.from_numpy(
                    np.ascontiguousarray(x[b:b + 1, ..., t])))
            np.testing.assert_allclose(folded[b, t].numpy(), one[0].numpy(),
                                       rtol=1e-5, atol=1e-6)
    want, _, _ = jmodel.encode_volume(variables["params"],
                                      variables["state"],
                                      jnp.asarray(x[1:2, ..., 2]))
    _close(folded[1, 2].numpy(), np.asarray(want)[0], "f32")


def test_frozen_encoder_records_no_graph(tiny_config):
    """The volume encoder is frozen: requires_grad False, no gradient after
    a backward, not in the optimizer, not trainable in the mask; the head
    gets gradients. ``param_count`` equals JAX's."""
    config = _cfg(tiny_config, TRAINING_LEARNING_RATE=1e-3)
    jmodel, variables, model = _pair(config)
    enc = model.encode_sequence(torch.from_numpy(_sequences(1, 3)))
    assert not enc.requires_grad and enc.grad_fn is None
    loss = model(torch.from_numpy(_sequences(1, 3))).square().sum()
    loss.backward()
    mask = model.trainable_mask()
    for name, p in model.named_parameters():
        frozen = name.startswith("volume_encoder.")
        assert mask[name] is not frozen
        assert p.requires_grad is not frozen
        if frozen:
            assert p.grad is None, name
    head = [p.grad for n, p in model.named_parameters() if mask[n]]
    assert sum(float(g.abs().sum()) for g in head) > 0
    opt = Optimizer(config, model.parameters(), steps_per_epoch=1)
    assert {id(p) for p in opt.params} == {
        id(p) for n, p in model.named_parameters() if mask[n]}
    assert model.param_count() == jmodel.param_count(variables["params"])


def _save_3d(tiny_config, tmp_path, jax_file: bool):
    """A 3D checkpoint (binary head) written by the port or by JAX; returns
    its path and its weights."""
    config3d = dict(tiny_config, DATASET_NAME="adni")
    path = str(tmp_path / ("jax3d.pkl" if jax_file else "port3d.pt"))
    if jax_file:
        jmodel = JaxNeuroEncoder(config3d)
        params = jmodel.init(jax.random.key(5))["params"]
        jax_sd.save(path, jax_sd.to_state_dict(jmodel, params))
        return path, from_jax_params(jax.tree.map(np.asarray, params))
    model = NeuroEncoder(config3d, device="cpu", seed=5)
    sd.save(path, model.state_dict())
    return path, model.state_dict()


@pytest.mark.parametrize("jax_file", [False, True])
def test_bootstrap_from_3d_checkpoint(tiny_config, tmp_path, jax_file):
    """load_pretrained_volume_encoder keeps the volume_encoder.vit3d. keys of
    a 3D run's file (the port's or the JAX package's): the encoder takes its
    weights, the temporal head keeps its own."""
    path, weights3d = _save_3d(tiny_config, tmp_path, jax_file)
    model = NeuroEncoder(_cfg(tiny_config), device="cpu", seed=6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    missing, unexpected = load_pretrained_volume_encoder(model, path)
    assert not unexpected
    assert all(not k.startswith(sd.PREFIX) for k in missing)
    for k, v in model.state_dict().items():
        if k.startswith(sd.PREFIX):
            assert torch.equal(v, weights3d[k]), k
        else:
            assert torch.equal(v, before[k]), k


def test_main_build_bootstraps_or_warns(tiny_config, tmp_path, capsys):
    """main.build loads BEST_MODEL_PATH into a 4D model's encoder when it
    exists and prints the JAX CLI's warning when it does not."""
    from neurovit_tpu_torch.main import build
    config = _cfg(tiny_config, DATASET_NAME="gradcam",
                  DATASET_GENERATE=True, GRADCAM_NUM_SAMPLES=8,
                  GLOBAL_BASE_PATH=str(tmp_path), BEST_MODEL_PATH="best.pt")
    build(config, torch.device("cpu"))
    assert "4D volume encoder starts from random init" in \
        capsys.readouterr().out
    weights3d = NeuroEncoder(dict(config, TRAINING_DIM=3), device="cpu",
                             seed=9).state_dict()
    sd.save(str(tmp_path / "best.pt"), weights3d)
    _, _, model = build(dict(config, DATASET_GENERATE=False),
                        torch.device("cpu"))
    assert "Loaded frozen volume encoder" in capsys.readouterr().out
    for key, v in weights3d.items():
        assert torch.equal(model.state_dict()[key], v), key


def test_resnet_encoder_in_4d_matches_jax(tiny_config):
    """The 3D ResNet (depth 10) as the frozen 4D encoder, eval mode (its
    running stats), against JAX at f32."""
    config = _cfg(tiny_config, MODEL_VOLUME_ENCODER="resnet",
                  MODEL_RESNET_DEPTH=10)
    jmodel, variables, model = _pair(config, seed=3)
    x = _sequences(1, 2, seed=4, grid=12)
    want, _ = jmodel.apply(variables["params"], jnp.asarray(x),
                           state=variables["state"])
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), want, "f32")
    assert all(not p.requires_grad for p in model.resnet_3d.parameters())
    assert model.param_count() == jmodel.param_count(variables["params"])
    with pytest.raises(ValueError, match="3D"):
        NeuroEncoder(_cfg(tiny_config), device="cpu").probe(
            torch.zeros(1, 20, 20, 20), torch.zeros(1, 65, 64))


def test_state_dict_keys_are_the_jax_files(tiny_config, tmp_path):
    """The port's 4D state dict has the JAX package's keys, and its file
    loads into the JAX model (load_variables_file, strict) with the same
    logits."""
    from neurovit_tpu.training import checkpoint as jax_ckpt
    config = _cfg(tiny_config)
    jmodel = JaxNeuroEncoder(config)
    model = NeuroEncoder(config, device="cpu", seed=7)
    path = str(tmp_path / "w.pkl")
    sd.save(path, model.state_dict())
    variables = jax_ckpt.load_variables_file(
        jmodel, jmodel.init(jax.random.key(0)), path, strict=True)
    assert set(model.state_dict()) == set(
        jax_sd.to_state_dict(jmodel, variables["params"]))
    x = _sequences(1, 3, seed=8)
    want, _ = jmodel.apply(variables["params"], jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), want, "f32")
