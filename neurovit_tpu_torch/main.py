"""Entry point of the port: train, resume, k-fold, sweep and inference.

Counterpart of the root ``main.py`` (the reference's CLI):

    python -m neurovit_tpu_torch.main [name] [--cuda N] [--wandb bool]
        [--config PATH] [--resume PATH] [--folds K] [--inference] [--sweep]

It trains on ``cuda:N`` (``--cuda``, the reference's own flag, default 0)
and never drops to the CPU: without CUDA it raises. ``--device cpu`` runs
the plain PyTorch path on purpose (tests, debugging). The modes take the
JAX CLI's order (main.py:69-124): training unless ``--inference`` or
``--sweep`` is given, then the sweep, then inference, so ``--inference
--sweep`` sweeps. ``--sweep`` runs ``SWEEP_COUNT`` (default 50) trials of
``GLOBAL_BASE_PATH/configs/sweep.yaml`` (``training.sweep.run_sweep``),
each a fresh model and ``Trainer.run``.

Data parallelism over N GPUs, one process each (main.py:54-60;
``parallel``):

    torchrun --standalone --nproc_per_node=N -m neurovit_tpu_torch.main ...

Rank r runs on ``cuda:LOCAL_RANK`` (``--cuda`` is not read then), the
ranks' collectives run on NCCL (gloo with ``--device cpu``), and the
process group starts before anything else touches the card.
``TRAINING_BATCH_SIZE`` is the global batch. ``--inference`` gathers the
ranks' predictions for rank 0's accuracy line.
"""

from __future__ import annotations

import argparse
import gc
import os
import warnings

import numpy as np
import torch

from neurovit_tpu_torch.config import get_config
from neurovit_tpu_torch.data import get_datasets
from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder
from neurovit_tpu_torch.parallel import distributed
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
                        help="Run hyperparameter sweep")
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
    """``--device cpu``, else ``cuda:LOCAL_RANK`` under torchrun and
    ``cuda:--cuda`` without it; a card that is not there raises."""
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: neurovit_tpu_torch trains on the card "
            "and does not drop to the CPU (pass --device cpu to run the "
            "plain PyTorch path on purpose)")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device(f"cuda:{args.cuda}")
    if int(local) >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card behind it: "
            f"{torch.cuda.device_count()} visible (run at most that many "
            "processes a node)")
    return torch.device(f"cuda:{int(local)}")


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


def sweep_trial(config, device: torch.device) -> dict:
    """One sweep trial: datasets, model and ``Trainer.run`` for the trial's
    config. The trial's model, optimizer and trainer are freed before the
    next trial is built, so card memory does not grow across a sweep."""
    ds_train, ds_val, model = build(config, device)
    trainer = Trainer(config, model, ds_train, ds_val)
    trainer.run()
    metrics = {"val_loss": trainer.val_loss}
    del trainer, model, ds_train, ds_val
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return metrics


def main(argv=None) -> None:
    warnings.simplefilter(action="ignore", category=FutureWarning)
    args = parse_args(argv)
    config = get_config(args)
    device = resolve_device(args)
    config["DEVICE"] = str(device)
    adopted = distributed.group() is not None
    if distributed.maybe_initialize(config, device):
        print(f"Distributed runtime: rank {distributed.rank()}/"
              f"{distributed.world_size()} on {device}")
    try:
        _run(config, device)
    finally:
        if not adopted:
            distributed.shutdown()


def _run(config, device: torch.device) -> None:
    if not config["INFERENCE"] and not config["SWEEP"]:
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
    elif config["SWEEP"]:
        print("Sweep mode enabled.")
        from neurovit_tpu_torch.training.sweep import run_sweep
        sweep_path = os.path.join(config["GLOBAL_BASE_PATH"],
                                  "configs/sweep.yaml")
        # 50 trials matches the reference's wandb.agent count (main.py:157).
        best = run_sweep(config, lambda c: sweep_trial(c, device),
                         sweep_path, count=config.get("SWEEP_COUNT", 50))
        print(f"Sweep finished: best={best}")
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
