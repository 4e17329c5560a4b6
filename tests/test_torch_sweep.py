"""The port's sweep (``neurovit_tpu_torch.training.sweep``, the config's
``apply_sweep_overrides`` and ``main --sweep``) against the JAX package's:
the same seed, space and metric history propose the same parameters,
exactly."""

import json
import os

import numpy as np
import pytest
import yaml

from neurovit_tpu import config as jax_config
from neurovit_tpu.training import sweep as jax_sweep
from neurovit_tpu_torch import config as port_config
from neurovit_tpu_torch import main as port_main
from neurovit_tpu_torch.training import sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(REPO, "configs", "sweep.yaml")) as f:
    REPO_SWEEP = yaml.safe_load(f)

SPACES = {
    "repo": REPO_SWEEP["parameters"],
    # value, values, a positive (log-uniform) and a signed (uniform) range.
    "mixed": {"seed": {"value": 7}, "dropout": {"values": [0.0, 0.1, 0.3]},
              "learning_rate": {"min": 1e-5, "max": 1e-1},
              "shift": {"min": -2.0, "max": 3.0}},
    "ranges": {"weight_decay": {"min": 0.0001, "max": 0.5},
               "bias": {"min": -1, "max": 1},
               "batch_size": {"values": [4, 8]},
               "epochs": {"value": 3}},
}


def _metric(trial, params):
    """A scripted metric history that depends on the proposal."""
    x = sum(float(v) for v in params.values()
            if isinstance(v, (int, float)))
    return float(np.sin(1.7 * trial + x) + 0.1 * trial)


@pytest.mark.parametrize("goal", ["minimize", "maximize"])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_tpe_proposals_equal_jax(space, goal):
    """12 trials, past the 8-trial random warm-up, each proposal fed back
    with the same metric: every proposal equals JAX's."""
    sign = 1.0 if goal == "minimize" else -1.0
    spec = SPACES[space]
    rng, jrng = np.random.RandomState(42), np.random.RandomState(42)
    history, jhistory = [], []
    assert sweep._TPE_WARMUP == jax_sweep._TPE_WARMUP == 8
    assert sweep._TPE_GAMMA == jax_sweep._TPE_GAMMA
    assert sweep._TPE_CANDIDATES == jax_sweep._TPE_CANDIDATES
    for trial in range(12):
        got = sweep.tpe_sample(spec, history, rng, sign)
        want = jax_sweep.tpe_sample(spec, jhistory, jrng, sign)
        assert got == want, (trial, got, want)
        assert [type(v) for v in got.values()] == \
            [type(v) for v in want.values()]
        history.append((got, _metric(trial, got)))
        jhistory.append((want, _metric(trial, want)))


@pytest.mark.parametrize("space", sorted(SPACES))
def test_random_proposals_equal_jax(space):
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(12):
        assert sweep.sample_params(SPACES[space], rng) == \
            jax_sweep.sample_params(SPACES[space], jrng)


def test_unsupported_spec_raises_as_jax():
    bad = {"x": {"distribution": "q_uniform"}}
    for fn in (sweep.sample_params, jax_sweep.sample_params):
        with pytest.raises(ValueError, match="Unsupported sweep spec for x"):
            fn(bad, np.random.RandomState(0))


def test_apply_sweep_overrides_equals_jax(tiny_config):
    params = {"learning_rate": 3e-4, "batch_size": 32, "dropout": 0.2,
              "weight_decay": 1e-3, "epochs": 10, "seed": 42,
              "num_workers": 16, "optimizer": "AdamW",
              "MODEL_VIT_DEPTH": 3}
    assert port_config.SWEEP_KEY_MAP == jax_config.SWEEP_KEY_MAP
    got = port_config.apply_sweep_overrides(tiny_config, params)
    want = jax_config.apply_sweep_overrides(tiny_config, params)
    assert got == want
    assert got["TRAINING_OPTIMIZER"] == "AdamW"
    assert got["MODEL_VIT_DEPTH"] == 3
    assert "learning_rate" not in got
    assert tiny_config["TRAINING_LEARNING_RATE"] != 3e-4   # a copy
    for fn in (port_config.apply_sweep_overrides,
               jax_config.apply_sweep_overrides):
        with pytest.raises(ValueError, match="must be divisible"):
            fn(tiny_config, {"TRAINING_VIT_PATCH_SIZE": 3})
        with pytest.raises(ValueError, match="Unknown DATASET_NAME"):
            fn(tiny_config, {"DATASET_NAME": "nope"})


@pytest.mark.parametrize("method", ["bayes", "random"])
def test_run_sweep_writes_jax_results(tiny_config, tmp_path, method):
    """run_sweep with a stub train_fn: the same sweep_results.jsonl lines
    (trial, params, metrics) and the same best as JAX's run_sweep."""
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(dict(REPO_SWEEP, method=method)))
    results = {}
    for name, run in (("port", sweep.run_sweep),
                      ("jax", jax_sweep.run_sweep)):
        out_dir = tmp_path / name
        config = dict(tiny_config, GLOBAL_OUTPUT_DIR=str(out_dir))
        seen = []

        def train_fn(cfg, seen=seen):
            seen.append(cfg)
            return {"val_loss": _metric(len(seen),
                                        {"lr": cfg["TRAINING_LEARNING_RATE"]})}

        best = run(config, train_fn, str(path), count=11)
        lines = (out_dir / "sweep_results.jsonl").read_text().splitlines()
        results[name] = (best, [json.loads(line) for line in lines], seen)
    (best, lines, seen), (jbest, jlines, jseen) = results["port"], results["jax"]
    assert best == jbest and best["trials"] == 11
    assert lines == jlines and len(lines) == 11
    assert [c["TRAINING_BATCH_SIZE"] for c in seen] == \
        [c["TRAINING_BATCH_SIZE"] for c in jseen]
    assert all(c["TRAINING_EPOCHS"] == 10 for c in seen)


def _sweep_base(tmp_path, tiny_config):
    """A GLOBAL_BASE_PATH holding configs/sweep.yaml (the repo's, cut to one
    epoch at batch 8) and a config of two sweep trials."""
    base = tmp_path / "base"
    (base / "configs").mkdir(parents=True)
    space = dict(REPO_SWEEP["parameters"], epochs={"values": [1]},
                 batch_size={"values": [8]}, num_workers={"value": 2})
    (base / "configs" / "sweep.yaml").write_text(
        yaml.safe_dump(dict(REPO_SWEEP, parameters=space)))
    config = dict(tiny_config, DATASET_GENERATE=True, GRADCAM_NUM_SAMPLES=24,
                  GLOBAL_BASE_PATH=str(base), SWEEP_COUNT=2,
                  GLOBAL_OUTPUT_DIR=str(tmp_path / "runs"))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(config))
    return str(cfg), config


@pytest.mark.parametrize("flags", [["--sweep"], ["--inference", "--sweep"]])
def test_main_sweep_runs_the_trials(tiny_config, tmp_path, monkeypatch,
                                    capsys, flags):
    """``main --sweep --device cpu`` (and ``--inference --sweep``, which
    sweeps, as the JAX CLI does) runs SWEEP_COUNT trials, each a Trainer
    run, and writes their params: those the sweep proposes at the seed."""
    monkeypatch.chdir(tmp_path)          # the rolling ./results/last_model
    cfg, config = _sweep_base(tmp_path, tiny_config)
    port_main.main([*flags, "--device", "cpu", "--wandb", "false",
                    "--config", cfg])
    out = capsys.readouterr().out
    assert "Sweep mode enabled." in out and "Sweep finished: best=" in out
    assert "Inference only" not in out and "Training mode" not in out
    assert out.count("[VALIDATION] epoch 0") == 2
    lines = [json.loads(line) for line in open(os.path.join(
        config["GLOBAL_OUTPUT_DIR"], "sweep_results.jsonl"))]
    assert [r["trial"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["metrics"]["val_loss"]) for r in lines)
    rng = np.random.RandomState(config["TRAINING_SEED"])
    with open(os.path.join(config["GLOBAL_BASE_PATH"], "configs",
                           "sweep.yaml")) as f:
        space = yaml.safe_load(f)["parameters"]
    want = [jax_sweep.sample_params(space, rng) for _ in range(2)]
    assert [r["params"] for r in lines] == want
