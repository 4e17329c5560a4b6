"""Entry point of the port: train, resume, k-fold and inference.

Counterpart of the root ``main.py`` (the reference's CLI):

    python -m neurovit_tpu_torch.main [name] [--cuda N] [--wandb bool]
        [--config PATH] [--resume PATH] [--folds K] [--inference]

It trains on ``cuda:N`` (``--cuda``, the reference's own flag, default 0)
and never drops to the CPU: without CUDA it raises. ``--device cpu`` runs
the plain PyTorch path on purpose (tests, debugging). ``--sweep`` is not
ported yet and raises, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from neurovit_tpu_torch.config import get_config
from neurovit_tpu_torch.data import get_datasets
from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder, not_ported
from neurovit_tpu_torch.training import MetricLogger, Trainer
from neurovit_tpu_torch.training.checkpoint import (
    load_checkpoint, load_pretrained_volume_encoder)


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's flags (neurovit_tpu/config.py:187-212) plus
    ``--device``."""
    parser = argparse.ArgumentParser(
        description="Train or Evaluate fMRI Model (PyTorch, CUDA)")
    parser.add_argument("name", type=str, nargs="?", default=None,
                        help="Run name (optional)")
    parser.add_argument("--inference", action="store_true",
                        help="Run in inference mode")
    parser.add_argument("--sweep", action="store_true",
                        help="Run hyperparameter sweep (not ported yet)")
    parser.add_argument("--cuda", type=int, default=0,
                        help="CUDA device ordinal: runs on cuda:N")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu runs the plain PyTorch path (tests); the "
                             "default cuda never falls back to it")
    parser.add_argument("--wandb", type=lambda x: str(x).lower() == "true",
                        default=True,
                        help="Enable metric tracking (wandb if installed, "
                             "else local JSONL)")
    parser.add_argument("--config", type=str, default=None,
                        help="Config YAML path (default: configs/config.yaml)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Resume training from a train-state checkpoint "
                             "(weights + optimizer + epoch + dropout stream)")
    parser.add_argument("--folds", type=int, default=0,
                        help="Run k-fold cross-validation over fold indexes "
                             "written by generate_folds")
    return parser.parse_args(argv)


def resolve_device(args: argparse.Namespace) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: neurovit_tpu_torch trains on the card "
            "and does not drop to the CPU (pass --device cpu to run the "
            "plain PyTorch path on purpose)")
    return torch.device(f"cuda:{args.cuda}")


def build(config, device: torch.device):
    """Datasets and a seeded model on ``device`` (root main.py:28-45). A 4D
    model's frozen volume encoder is bootstrapped from the 3D checkpoint
    at ``BEST_MODEL_PATH`` when that file exists."""
    np.random.seed(config["TRAINING_SEED"])
    torch.manual_seed(config["TRAINING_SEED"])
    dataset_train, dataset_val = get_datasets(config)
    model = NeuroEncoder(config, device=device)
    if model.is_4d:
        best = os.path.join(config["GLOBAL_BASE_PATH"],
                            config["BEST_MODEL_PATH"])
        if os.path.exists(best):
            load_pretrained_volume_encoder(model, best)
            print(f"Loaded frozen volume encoder from {best}")
        else:
            print(f"WARNING: BEST_MODEL_PATH {best} not found; "
                  f"4D volume encoder starts from random init")
    return dataset_train, dataset_val, model


def main(argv=None) -> None:
    warnings.simplefilter(action="ignore", category=FutureWarning)
    args = parse_args(argv)
    config = get_config(args)
    device = resolve_device(args)
    config["DEVICE"] = str(device)

    if config["SWEEP"]:
        raise not_ported("--sweep", "train step, sweep")
    if not config["INFERENCE"]:
        print("Training mode enabled.")
        folds = config.get("FOLDS", 0)
        if folds:
            folds_dir = config.get("DATASET_FOLDS_DIR", "./src/data")
            for fold in range(1, folds + 1):
                print(f"FOLD {fold}/{folds} training...")
                fold_config = dict(config)
                train_pkl = os.path.join(folds_dir, f"fold_{fold}",
                                         "train_data.pkl")
                val_pkl = os.path.join(folds_dir, f"fold_{fold}",
                                       "val_data.pkl")
                for key in ("ADNI_TRAIN_PATH", "PAIN_TRAIN_PKL_PATH"):
                    fold_config[key] = train_pkl
                for key in ("ADNI_VAL_PATH", "PAIN_VAL_PKL_PATH"):
                    fold_config[key] = val_pkl
                ds_train, ds_val, model = build(fold_config, device)
                Trainer(fold_config, model, ds_train, ds_val).run()
                print(f"FOLD {fold}/{folds} completed.")
                print("=" * 50)
            return
        logger = MetricLogger(config)
        dataset_train, dataset_val, model = build(config, device)
        trainer = Trainer(config, model, dataset_train, dataset_val,
                          logger=logger)
        if config.get("RESUME"):
            trainer.restore(config["RESUME"])
            print(f"Resumed from {config['RESUME']} at epoch {trainer.epoch}")
        trainer.run()
        logger.finish()
    else:
        print("Training is disabled. Inference only.")
        dataset_train, dataset_val, model = build(config, device)
        best = os.path.join(config["GLOBAL_BASE_PATH"],
                            config["BEST_MODEL_PATH"])
        load_checkpoint(model, best, strict=False)
        trainer = Trainer(config, model, dataset_train, dataset_val)
        trainer.evaluate_samples()


if __name__ == "__main__":
    main()
