"""Asynchronous train-state saves (``save_train_state(...,
asynchronous=True)``, ``wait_for_async_saves``, ``TRAINING_ASYNC_CHECKPOINT``)
after the JAX package's tests/test_checkpoint.py:45-92, on the CPU plain
path: the snapshot is taken before the call returns, the write commits at
the wait, a failed write raises there, and the files equal a synchronous
run's."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from neurovit_tpu.models import NeuroEncoder as JaxNeuroEncoder
from neurovit_tpu.training import checkpoint as jax_ckpt
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

BATCH, CLASSES = 8, 8


class _Volumes:
    def __len__(self):
        return 3 * BATCH

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20).astype(np.float32),
                "label": idx % CLASSES, "subject": f"s{idx}", "timepoint": 0}


def _config(tiny, out_dir, **extra):
    return {**tiny, "TRAINING_BATCH_SIZE": BATCH, "TRAINING_DROPOUT": 0.1,
            "TRAINING_LEARNING_RATE": 1e-3,
            "GLOBAL_OUTPUT_DIR": str(out_dir), **extra}


def _trainer(config, seed=None):
    return Trainer(config, NeuroEncoder(config, device="cpu", seed=seed),
                   _Volumes(), _Volumes())


def _batch(trainer):
    batch, zyx, _ = next(trainer._device_prefetch(trainer.dataloader))
    return batch, zyx


def _equal_states(a, b, where=""):
    """Two loaded train states hold equal values, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal_states(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_states(x, y, f"{where}/{i}")
    else:
        assert a == b, (where, a, b)


def test_async_save_is_not_altered_by_later_steps(tiny_config, tmp_path):
    """Save asynchronously, take one more step (AdamW updates the live
    parameters and moments in place) before the wait: the checkpoint
    restores the state before that step, exactly."""
    trainer = _trainer(_config(tiny_config, tmp_path))
    batch, zyx = _batch(trainer)
    trainer.train_step(batch, zyx)
    trainer.epoch = 1
    path = str(tmp_path / "ckpt" / "model-e0")
    want = ckpt._host_copy(trainer._checkpoint_state())
    ckpt.save_train_state(path, trainer._checkpoint_state(), trainer.model,
                          asynchronous=True)
    loss_after = float(trainer.train_step(batch, zyx)["loss"])
    moved = trainer.model.state_dict()
    assert any(not torch.equal(moved[k], want["model"][k]) for k in moved)
    ckpt.wait_for_async_saves()
    assert not os.path.exists(path + ".partial")
    _equal_states(ckpt.load_train_state(path), want)

    other = _trainer(_config(tiny_config, tmp_path), seed=1)
    other.restore(path)
    assert other.epoch == 1
    assert float(other.train_step(batch, zyx)["loss"]) == loss_after


def _run(config):
    trainer = _trainer(config)
    trainer.run()
    files = sorted(glob.glob(os.path.join(config["GLOBAL_OUTPUT_DIR"], "*",
                                          "model-e*")))
    return trainer, files


def test_async_run_equals_sync_run(tiny_config, tmp_path, monkeypatch):
    """Two epochs with TRAINING_ASYNC_CHECKPOINT and two without, on the
    same seeds: every model-e{N} train state and weights file is equal,
    the run leaves no save in flight, and each restores to the same next
    step."""
    monkeypatch.chdir(tmp_path)          # the rolling ./results/last_model
    runs = {}
    for mode in (False, True):
        config = _config(tiny_config, tmp_path / f"runs_{mode}",
                         TRAINING_EPOCHS=2, TRAINING_ASYNC_CHECKPOINT=mode)
        runs[mode] = _run(config)
        assert ckpt._in_flight is None
    (sync_trainer, sync_files), (_, async_files) = runs[False], runs[True]
    names = [os.path.basename(f) for f in sync_files]
    assert names == ["model-e0", "model-e0.state_dict.pkl", "model-e1",
                     "model-e1.state_dict.pkl"]
    assert [os.path.basename(f) for f in async_files] == names
    for a, b in zip(sync_files, async_files):
        load = (ckpt.load_train_state if not a.endswith(".pkl")
                else lambda p: torch.load(p, weights_only=True))
        _equal_states(load(a), load(b), os.path.basename(a))

    batch, zyx = _batch(sync_trainer)
    losses = []
    for path in (sync_files[2], async_files[2]):
        other = _trainer(_config(tiny_config, tmp_path, TRAINING_EPOCHS=2),
                         seed=3)
        other.restore(path)
        assert other.epoch == 2
        losses.append(float(other.train_step(batch, zyx)["loss"]))
    assert losses[0] == losses[1]


def test_failed_write_raises_at_the_wait(tiny_config, tmp_path, monkeypatch):
    """A writer-thread error is raised again by wait_for_async_saves (and
    by the next save, which waits first), never swallowed; the weights
    file is written all the same."""
    trainer = _trainer(_config(tiny_config, tmp_path))
    state = trainer._checkpoint_state()

    def failing(_state, _path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", failing)
    path = str(tmp_path / "model-e0")
    ckpt.save_train_state(path, state, trainer.model, asynchronous=True)
    assert os.path.exists(path + ".state_dict.pkl")
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_async_saves()
    ckpt.wait_for_async_saves()          # raised once, then cleared
    ckpt.save_train_state(path, state, trainer.model, asynchronous=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_train_state(path, state, trainer.model, asynchronous=True)
    assert ckpt._in_flight is None


def test_failed_write_raises_out_of_run(tiny_config, tmp_path, monkeypatch):
    """Trainer.run's exit wait raises the last epoch's failed write."""
    monkeypatch.chdir(tmp_path)

    def failing(_state, _path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", failing)
    config = _config(tiny_config, tmp_path / "runs",
                     TRAINING_ASYNC_CHECKPOINT=True)
    with pytest.raises(OSError, match="disk full"):
        _trainer(config).run()
    assert ckpt._in_flight is None


def test_async_weights_file_loads_in_jax(tiny_config, tmp_path, monkeypatch):
    """The async run's model-e0.state_dict.pkl loads into the JAX model
    (strict) and gives the port's logits."""
    monkeypatch.chdir(tmp_path)
    config = _config(tiny_config, tmp_path / "runs", KERNEL_IMPL="xla",
                     TRAINING_ASYNC_CHECKPOINT=True)
    trainer, files = _run(config)
    pkl = [f for f in files if f.endswith("model-e0.state_dict.pkl")]
    assert len(pkl) == 1
    jmodel = JaxNeuroEncoder(config)
    variables = jax_ckpt.load_variables_file(
        jmodel, jmodel.init(jax.random.key(0)), pkl[0], strict=True)
    vols = np.stack([_Volumes().sample(i)["volume"] for i in range(2)])
    want, _ = jmodel.apply(variables["params"], jax.numpy.asarray(vols))
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(vols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
