"""``neurovit_tpu_torch.utils.profiling`` (``trace``, ``StepTimer``) and the
Trainer's ``TRAINING_PROFILE_STEPS`` window (steps 2 .. 2 + n of epoch 0,
neurovit_tpu/training/trainer.py:524-545), on the CPU plain path."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.training import Trainer
from neurovit_tpu_torch.utils import profiling

torch.set_num_threads(1)

BATCH, CLASSES = 4, 8


class _Volumes:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20).astype(np.float32),
                "label": idx % CLASSES, "subject": f"s{idx}", "timepoint": 0}


def test_step_timer_statistics(monkeypatch):
    clock = iter([1.0, 1.5, 2.5, 3.0, 5.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    assert timer.summary() is None
    timer.mark()
    timer.mark()
    timer.mark()
    timer.mark({"loss": torch.ones(2), "parts": [torch.zeros(1)]})
    stats = timer.summary()     # waits for the last result, reads 5.0
    deltas = np.array([0.5, 1.0, 0.5, 2.0])
    assert stats == {"steps": 4, "mean_s": float(deltas.mean()),
                     "p50_s": float(np.percentile(deltas, 50)),
                     "p95_s": float(np.percentile(deltas, 95)),
                     "steps_per_sec": float(1 / deltas.mean())}
    timer.reset()
    assert timer.summary() is None


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), cuda=False):
        torch.nn.functional.gelu(torch.ones(64, 64) @ torch.ones(64, 64))
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::mm" in names and "aten::gelu" in names
    assert not torch.autograd._profiler_enabled()


def test_trace_stops_when_the_body_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with profiling.trace(str(tmp_path), cuda=False):
            raise RuntimeError("boom")
    assert not torch.autograd._profiler_enabled()
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1


def _trainer(tiny_config, n_train, profile_steps, epochs=1):
    config = {**tiny_config, "TRAINING_BATCH_SIZE": BATCH,
              "TRAINING_EPOCHS": epochs,
              "TRAINING_PROFILE_STEPS": profile_steps}
    trainer = Trainer(config, NeuroEncoder(config, device="cpu"),
                      _Volumes(n_train), _Volumes(BATCH))
    traced = []
    step = trainer.train_step

    def recorded(*args, **kwargs):
        traced.append(torch.autograd._profiler_enabled())
        return step(*args, **kwargs)

    trainer.train_step = recorded
    return trainer, traced, os.path.join(config["GLOBAL_OUTPUT_DIR"],
                                         "profile")


@pytest.mark.parametrize("n", [1, 2])
def test_trainer_traces_steps_2_to_2_plus_n_of_epoch_0(tiny_config, n):
    """Six batches an epoch, two epochs: steps 2 .. 2 + n of epoch 0 run
    under the profiler, no step of epoch 1 does, and one trace holding the
    kernels' autograd functions is under GLOBAL_OUTPUT_DIR/profile."""
    trainer, traced, prof_dir = _trainer(tiny_config, 6 * BATCH, n, epochs=2)
    trainer.run()
    window = [2 <= i <= 2 + n for i in range(6)]
    assert traced == window + [False] * 6
    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    for fn in ("FusedLnQkv", "FlashAttention", "FusedOutproj", "FusedMlp"):
        assert any(fn in str(name) for name in names), fn
    assert not torch.autograd._profiler_enabled()


def test_short_epoch_and_preemption_stop_the_trace(tiny_config):
    """An epoch of 4 steps with a window of 10 stops the trace at the
    epoch's end; a preemption inside the window stops it at the break.
    No profiler is left running and each run leaves its trace."""
    trainer, traced, prof_dir = _trainer(tiny_config, 4 * BATCH, 10)
    trainer.run()
    assert traced == [False, False, True, True]
    assert not torch.autograd._profiler_enabled()
    assert len(glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))) == 1

    trainer, traced, _ = _trainer(tiny_config, 6 * BATCH, 10)
    step = trainer.train_step

    def preempt_after_step_3(*args, **kwargs):
        out = step(*args, **kwargs)
        if len(traced) == 4:
            trainer.request_preempt()
        return out

    trainer.train_step = preempt_after_step_3
    trainer.run()
    assert traced == [False, False, True, True]
    assert not torch.autograd._profiler_enabled()
    assert len(glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))) == 2
    assert glob.glob(os.path.join(tiny_config["GLOBAL_OUTPUT_DIR"], "*",
                                  "model-preempt"))
