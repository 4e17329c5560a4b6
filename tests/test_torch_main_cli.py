"""``python -m neurovit_tpu_torch.main``: train one epoch and run inference
on the plain path (``--device cpu``) at a tiny synthetic-cube config, with
the JAX CLI's banner and log lines; refuse what is not ported."""

import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from neurovit_tpu_torch import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_config(tmp_path, tiny_config):
    config = dict(tiny_config)
    config.update({
        "DATASET_GENERATE": True, "GRADCAM_NUM_SAMPLES": 40,
        "TRAINING_EPOCHS": 1, "TRAINING_DROPOUT": 0.1,
        "BEST_MODEL_PATH": str(tmp_path / "best.pkl"),
    })
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _run(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "neurovit_tpu_torch.main",
                          *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_then_inference(tiny_config, tmp_path):
    cfg = _write_config(tmp_path, tiny_config)
    out = _run(["cli-test", "--device", "cpu", "--wandb", "false",
                "--config", cfg], tmp_path)
    assert "Training mode enabled." in out
    assert "Model total parameters: 0.08M (trainable 0.08M and frozen " \
           "0.00M)" in out
    assert "Number of batches training: 4 of size 8" in out
    assert "epoch 0\t| batch 1/4\t| train_loss: " in out
    assert "[VALIDATION] epoch 0\t| total_batch 0\t| val_loss " in out
    assert "MODEL SAVED to ." in out
    runs = os.path.join(tiny_config["GLOBAL_OUTPUT_DIR"], "*")
    assert glob.glob(os.path.join(runs, "model-e0"))
    pkl = glob.glob(os.path.join(runs, "model-e0.state_dict.pkl"))
    assert pkl and os.path.exists(tmp_path / "results" / "last_model.pkl")

    shutil.copy(pkl[0], tmp_path / "best.pkl")
    out = _run(["--inference", "--device", "cpu", "--wandb", "false",
                "--config", cfg], tmp_path)
    assert "Training is disabled. Inference only." in out
    assert "Accuracy: " in out and "Wrong predictions: " in out


def test_refusals(tiny_config, tmp_path, monkeypatch):
    cfg = _write_config(tmp_path, tiny_config)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not drop to the CPU"):
        port_main.main(["--wandb", "false", "--config", cfg])
    assert port_main.parse_args(["--cuda", "1"]).cuda == 1
