"""The port's Trainer against the JAX Trainer, on the same weights and
batches, at a tiny 3D ViT (grid 20, patch 5, dim 64, depth 2, 4 heads of
16, MLP 128; 126 tokens), dropout 0.

The JAX side runs ``KERNEL_IMPL: pallas`` (its Pallas kernels in interpret
mode on the CPU) on one device. Tolerances: f32 within 1e-5 abs + 1e-4 rel
of each loss and updated parameter (AdamW's update is lr * m / (sqrt(v) +
eps) in both, rounded in another order); bf16 within 5e-2 of the largest
magnitude of each tensor (the same rounding points; bf16 gradients differ
by an ulp now and then and Adam's first steps amplify the sign of small
gradients).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.data import get_datasets
from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.parallel import create_mesh, shard_batch
from neurovit_tpu.training import Trainer as JaxTrainer
from neurovit_tpu.training import checkpoint as jax_ckpt
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training import checkpoint as ckpt
from neurovit_tpu_torch.training.state_dict import from_jax_params

torch.set_num_threads(1)

BATCH, CLASSES = 8, 8


class _Volumes:
    """A fixed dataset the Trainers can build their loaders on."""

    def __len__(self):
        return 4 * BATCH

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20).astype(np.float32),
                "label": idx % CLASSES, "subject": f"s{idx}", "timepoint": 0}


def _batches(n):
    rng = np.random.RandomState(7)
    return [{"volume": rng.randn(BATCH, 20, 20, 20).astype(np.float32),
             "label": rng.randint(0, CLASSES, BATCH).astype(np.int32),
             "valid": np.arange(BATCH) < BATCH - i}      # last rows padding
            for i in range(n)]


def _torch_batch(b):
    return {"volume": torch.from_numpy(b["volume"]),
            "label": torch.from_numpy(b["label"]).long(),
            "valid": torch.from_numpy(b["valid"])}


def _config(tiny, precision, **extra):
    config = dict(tiny)
    config.update({"KERNEL_IMPL": "pallas", "TRAINING_PRECISION": precision,
                   "TRAINING_LEARNING_RATE": 1e-3, "TRAINING_EPOCHS": 2,
                   "TRAINING_BATCH_SIZE": BATCH, **extra})
    return config


def _both(config):
    """A JAX Trainer on one device and a port Trainer with its weights."""
    jmodel = JaxNeuroEncoder(config)
    mesh = create_mesh(config, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(config, jmodel, _Volumes(), _Volumes(), mesh=mesh)
    params = jax.tree.map(np.asarray, jtrainer.train_state["params"])
    model = NeuroEncoder(config, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return jtrainer, mesh, Trainer(config, model, _Volumes(), _Volumes())


def _assert_close(got, want, precision):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=5e-2 * max(float(np.abs(want).max()),
                                               1e-6))


def _compare_steps(config, precision, n_steps):
    jtrainer, mesh, trainer = _both(config)
    for b in _batches(n_steps):
        jb = shard_batch(jtrainer._device_batch(b)[0], mesh)
        jtrainer.train_state, jm = jtrainer._train_step(jtrainer.train_state,
                                                        jb)
        m = trainer.train_step(_torch_batch(b))
        _assert_close(float(m["loss"]), float(jm["loss"]), precision)
        assert int(m["correct"]) == int(jm["correct"])
        assert int(m["count"]) == int(jm["count"])
    want = from_jax_params(jax.tree.map(np.asarray,
                                        jtrainer.train_state["params"]))
    got = trainer.model.state_dict()
    for key in want:
        _assert_close(got[key].numpy(), want[key].numpy(), precision)
    assert trainer.optimizer.current_lr() == pytest.approx(
        jtrainer._lr_fn(jtrainer.train_state["opt_state"]), rel=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "plateau"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_train_steps_match_jax(tiny_config, precision, schedule):
    """Two steps (the second with a padding row): losses, metrics, every
    updated parameter, and the LR of each schedule."""
    config = _config(tiny_config, precision, TRAINING_LR_SCHEDULE=schedule)
    _compare_steps(config, precision, n_steps=2)


def test_accumulation_matches_jax_multisteps(tiny_config):
    """TRAINING_ACCUMULATION_STEP 2: the first micro-batch moves nothing,
    the second takes the mean gradient's step, as optax.MultiSteps."""
    config = _config(tiny_config, "f32", TRAINING_ACCUMULATION_STEP=2)
    jtrainer, mesh, trainer = _both(config)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    b1, b2 = _batches(2)
    trainer.train_step(_torch_batch(b1))
    assert all(torch.equal(before[k], v)
               for k, v in trainer.model.state_dict().items())
    trainer.train_step(_torch_batch(b2))
    for b in (b1, b2):
        jb = shard_batch(jtrainer._device_batch(b)[0], mesh)
        jtrainer.train_state, _ = jtrainer._train_step(jtrainer.train_state,
                                                       jb)
    want = from_jax_params(jax.tree.map(np.asarray,
                                        jtrainer.train_state["params"]))
    for key, v in trainer.model.state_dict().items():
        _assert_close(v.numpy(), want[key].numpy(), "f32")


def test_restore_gives_the_same_next_step(tiny_config, tmp_path):
    """Save, then restore into a fresh Trainer: the next step (dropout on,
    so the seed stream is restored too) gives the identical loss."""
    config = _config(tiny_config, "f32", TRAINING_DROPOUT=0.1,
                     TRAINING_LR_SCHEDULE="plateau")
    b1, b2 = (_torch_batch(b) for b in _batches(2))
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                      _Volumes())
    trainer.train_step(b1)
    trainer.epoch, trainer._plateau_bad_epochs = 1, 1
    path = str(tmp_path / "state")
    ckpt.save_train_state(path, trainer._checkpoint_state(), trainer.model)
    want = float(trainer.train_step(b2)["loss"])

    other = Trainer(config, NeuroEncoder(config, device="cpu", seed=1),
                    _Volumes(), _Volumes())
    other.restore(path)
    assert other.epoch == 1 and other._plateau_bad_epochs == 1
    assert float(other.train_step(b2)["loss"]) == want
    for (k, v), w in zip(other.model.state_dict().items(),
                         trainer.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_checkpoint_loads_in_jax(tiny_config, tmp_path, monkeypatch):
    """Trainer.run() writes model-e0 and model-e0.state_dict.pkl; the
    weights load into the JAX model through load_variables_file and give
    the port's logits."""
    monkeypatch.chdir(tmp_path)          # the rolling ./results/last_model
    config = _config(tiny_config, "f32", TRAINING_EPOCHS=1,
                     KERNEL_IMPL="xla", TRAINING_DROPOUT=0.1)
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                      _Volumes())
    trainer.run()
    pkl = glob.glob(os.path.join(config["GLOBAL_OUTPUT_DIR"], "*",
                                 "model-e0.state_dict.pkl"))
    assert len(pkl) == 1 and os.path.exists(pkl[0][:-len(".state_dict.pkl")])
    jmodel = JaxNeuroEncoder(config)
    variables = jax_ckpt.load_variables_file(
        jmodel, jmodel.init(jax.random.key(0)), pkl[0], strict=True)
    vols = _batches(1)[0]["volume"][:2]
    want, _ = jmodel.apply(variables["params"], jax.numpy.asarray(vols))
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(vols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_synthetic_cube_training_learns(tiny_config):
    """Three epochs of the synthetic cube-position task (8 classes) with
    dropout 0.1 in bf16 reach the accuracy the JAX trainer reaches
    (tests/test_trainer_synthetic.py)."""
    config = _config(tiny_config, "bf16", TRAINING_EPOCHS=3,
                     TRAINING_DROPOUT=0.1, DATASET_GENERATE=True,
                     GRADCAM_NUM_SAMPLES=200)
    ds_train, ds_val = get_datasets(config)
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"), ds_train,
                      ds_val)
    trainer.run()
    assert trainer.evaluate_samples() > 0.9


def test_plateau_halves_the_lr_after_patience(tiny_config):
    config = _config(tiny_config, "f32", TRAINING_LR_SCHEDULE="plateau",
                     TRAINING_PLATEAU_PATIENCE=1)
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                      _Volumes())
    lr = trainer.optimizer.current_lr()
    for loss, want in [(1.0, lr), (1.0, lr), (1.0, lr / 2), (0.5, lr / 2),
                       (0.6, lr / 2), (0.6, lr / 4)]:
        trainer._plateau_step(loss)
        assert trainer.optimizer.current_lr() == pytest.approx(want)


@pytest.mark.parametrize("extra,item", [
    ({"MESH_DATA_AXIS": 2}, "multi-GPU"),
    ({"MESH_PIPE_AXIS": 2}, "multi-GPU"),
])
def test_unported_training_options_name_their_roadmap_item(tiny_config,
                                                            extra, item):
    """Data and tensor parallelism are ported: a data axis of 2 in one
    process is create_mesh's error (JAX's, mesh.py:36-37); pipeline
    parallelism still raises not_ported with its ROADMAP item."""
    config = _config(tiny_config, "f32", **extra)
    if "MESH_DATA_AXIS" in extra:
        with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
            Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                    _Volumes())
        return
    with pytest.raises(NotImplementedError,
                       match=f"pipeline parallelism.*Queue 1: {item}"):
        Trainer(config, NeuroEncoder(config, device="cpu"), _Volumes(),
                _Volumes())
