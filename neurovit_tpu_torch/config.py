"""Config: flat UPPERCASE-key YAML dicts and the runtime keys of the CLI.

The port's own copy of ``neurovit_tpu/config.py`` (the reference's
``main.py:20-62`` and ``configs/config.yaml``), with the same names and
behaviour: ``load_config`` (config.py:140-155) reads the YAML, fills
``EXTRA_DEFAULTS`` (config.py:52-130) and checks it with
``validate_config`` (config.py:158-174, ``REQUIRED_KEYS`` config.py:39-48);
``get_config`` (config.py:215-227) adds the runtime keys from the CLI's
arguments; ``apply_sweep_overrides`` (config.py:27-36, 177-184) maps a
sweep's lowercase parameter names onto the UPPERCASE keys.
``default_config_path`` is still the repository's ``configs/config.yaml``.
The CLI flags are ``neurovit_tpu_torch.main``'s own ``parse_args``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import yaml

# Map wandb-sweep parameter names (reference configs/sweep.yaml:8-25) onto the
# UPPERCASE config keys actually read by the framework. The reference's
# dict.update of these lowercase keys was inert (quirk: main.py:73-76).
# TRAINING_OPTIMIZER is read by nobody: AdamW is the only optimizer.
SWEEP_KEY_MAP = {
    "seed": "TRAINING_SEED",
    "num_workers": "TRAINING_NUM_WORKERS",
    "learning_rate": "TRAINING_LEARNING_RATE",
    "batch_size": "TRAINING_BATCH_SIZE",
    "epochs": "TRAINING_EPOCHS",
    "dropout": "TRAINING_DROPOUT",
    "weight_decay": "TRAINING_WEIGHT_DECAY",
    "optimizer": "TRAINING_OPTIMIZER",
}

# Keys every config must define to run training (subset of config.yaml keys).
REQUIRED_KEYS = (
    "TRAINING_SEED",
    "TRAINING_DIM",
    "TRAINING_EPOCHS",
    "TRAINING_BATCH_SIZE",
    "TRAINING_LEARNING_RATE",
    "TRAINING_VIT_INPUT_SIZE",
    "TRAINING_VIT_PATCH_SIZE",
    "DATASET_NAME",
)

# Defaults for keys the framework adds beyond the reference surface. All are
# optional in YAML; reference behavior is preserved when they are absent.
EXTRA_DEFAULTS: Dict[str, Any] = {
    # "vit" (reference NeuroEncoder.py:21 hardwires ViT3DEncoder) or "resnet"
    # (wires in the 3D ResNet baseline the reference left dangling).
    "MODEL_VOLUME_ENCODER": "vit",
    "MODEL_RESNET_DEPTH": 18,
    # ViT hyperparameters the reference hardcodes (NeuroEncoder.py:181-195).
    "MODEL_VIT_DIM": 1024,
    "MODEL_VIT_DEPTH": 6,
    "MODEL_VIT_HEADS": 8,
    "MODEL_VIT_DIM_HEAD": 64,
    "MODEL_VIT_MLP_DIM": 2048,
    "MODEL_VIT_POOL": "cls",
    # Kernel implementation: "pallas" (fused TPU kernels) or "xla" (reference
    # semantics via jnp; also the CPU-test path).
    "KERNEL_IMPL": "auto",
    # Mixed precision: bf16 compute / f32 params (TPU-native replacement for
    # the reference's fp16 GradScaler AMP, Trainer.py:29,68).
    "TRAINING_PRECISION": "bf16",
    "TRAINING_ACCUMULATION_STEP": 1,
    # constant (reference active path) | cosine | plateau (Trainer.py:32-33)
    "TRAINING_LR_SCHEDULE": "constant",
    "TRAINING_PLATEAU_PATIENCE": 1,
    "TRAINING_PLATEAU_FACTOR": 0.5,
    "TRAINING_WEIGHT_DECAY": 0.01,
    "TRAINING_DROPOUT": 0.0,
    "TRAINING_NUM_WORKERS": 8,
    "TRAINING_REMAT": False,       # jax.checkpoint the transformer blocks
    # PRNG impl for training-step dropout keys: "rbg" uses the TPU-native
    # XLA RngBitGenerator (threefry mask generation costs ~25% of a step
    # on the flagship model); "threefry2x32" for bit-stable portability.
    "TRAINING_RNG_IMPL": "rbg",
    "TRAINING_DONATE": True,       # donate train-state buffers to the step
    # 4D: encode each sequence ONCE through the deterministic frozen
    # encoder and train the temporal head on cached [T, C] features
    # (training/feature_cache.py — skips the ~98% encoder share of every
    # epoch after the first). Requires a static (non-augmented) 4D dataset.
    "TRAINING_4D_FEATURE_CACHE": False,
    # 4D: 'int8' runs the frozen encoder's GEMMs on the int8 MXU during
    # training (ops/int8_serving); convergence-gated, ~0.1-1% feature
    # perturbation (tests/test_trainer_4d_quant.py).
    "TRAINING_4D_ENCODER_QUANT": "none",
    # Temporal-layer dropout: the reference keeps the torch default 0.1
    # (NeuroEncoder.py:211-212) independent of TRAINING_DROPOUT.
    "MODEL_TEMPORAL_DROPOUT": 0.1,
    # Overlap the per-epoch Orbax disk write with the next epoch (the
    # device->host snapshot is still synchronous, so donated buffers stay
    # safe). The run exit / --resume paths wait for in-flight writes.
    "TRAINING_ASYNC_CHECKPOINT": False,
    # Mesh axes: data parallel by default; model axis enables tensor
    # parallel, pipe axis GPipe pipeline parallelism (parallel/pipeline.py).
    "MESH_DATA_AXIS": -1,          # -1 = all devices on the data axis
    "MESH_MODEL_AXIS": 1,
    "MESH_PIPE_AXIS": 1,
    # Microbatches per pipelined step; 0 = auto (2 * stages, halved until
    # it divides the batch). Bubble fraction = (P-1)/(M+P-1).
    "MESH_PP_MICROBATCHES": 0,
    # Opt-in native C++ NIfTI reader of the JAX package; not ported (true
    # raises): the port reads through numpy (data/nifti.py).
    "DATA_NATIVE_IO": False,
    "DATASET_TASK": "age",
    "DATASET_GENERATE": False,
    "DATASET_VISUALIZE_SAMPLES": False,
    "DATASET_TRANSFORMS": False,
    "DATASET_SPLIT_RATIO": 0.85,
    "GRADCAM_CUBE_SIZE": 8,
    "GRADCAM_BACKGROUND_NOISE": 0,
    "GRADCAM_NUM_SAMPLES": 4000,
    "GRADCAM_THRESHOLD": 5,
    "GRADCAM_THRESHOLD_3D": 0.5,
    "GRADCAM_SLICE_DIM": 2,
    "GRADCAM_SLICE_IDX": 45,
    "GRADCAM_SAVE_ATTENTION": False,
    "GLOBAL_OUTPUT_DIR": "./results/runs",
    "GLOBAL_BASE_PATH": ".",
    "WANDB_ENABLED": False,
    "NAME": None,
    "INFERENCE": False,
    "SWEEP": False,
}


def default_config_path() -> str:
    """Path of the default config, sibling ``configs/config.yaml`` of the repo
    root (reference hardcodes this relative path, main.py:49-52)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo_root, "configs", "config.yaml")


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load a flat UPPERCASE-key YAML config and fill framework defaults.

    Args:
        path: YAML file; defaults to ``configs/config.yaml`` at the repo root.
        overrides: optional dict merged on top (UPPERCASE keys).
    """
    path = path or default_config_path()
    with open(path) as f:
        config = yaml.safe_load(f) or {}
    merged = dict(EXTRA_DEFAULTS)
    merged.update(config)
    if overrides:
        merged.update(overrides)
    validate_config(merged)
    return merged


def validate_config(config: Dict[str, Any]) -> None:
    """Schema sanity checks (the reference has none; crashes late instead)."""
    missing = [k for k in REQUIRED_KEYS if k not in config]
    if missing:
        raise KeyError(f"Config missing required keys: {missing}")
    if config["TRAINING_DIM"] not in (3, 4):
        raise ValueError(f"TRAINING_DIM must be 3 or 4, got {config['TRAINING_DIM']}")
    grid = config["TRAINING_VIT_INPUT_SIZE"]
    patch = config["TRAINING_VIT_PATCH_SIZE"]
    if grid % patch != 0:
        # Same invariant as the reference's patchify asserts (vit_3d.py:83-84).
        raise ValueError(
            f"TRAINING_VIT_INPUT_SIZE ({grid}) must be divisible by "
            f"TRAINING_VIT_PATCH_SIZE ({patch})"
        )
    if config["DATASET_NAME"] not in ("adni", "adni4D", "pain", "gradcam"):
        raise ValueError(f"Unknown DATASET_NAME: {config['DATASET_NAME']}")


def apply_sweep_overrides(config: Dict[str, Any],
                          sweep_params: Dict[str, Any]) -> Dict[str, Any]:
    """Merge sweep parameters into a copy of ``config``, translating
    lowercase sweep names to the UPPERCASE keys the framework reads (fixes
    reference main.py:73-76), and validate the result."""
    out = dict(config)
    for key, value in sweep_params.items():
        out[SWEEP_KEY_MAP.get(key, key)] = value
    validate_config(out)
    return out


def get_config(args: argparse.Namespace) -> Dict[str, Any]:
    """Load config + inject runtime keys, mirroring reference main.py:49-62."""
    config = load_config(args.config)
    config["DEVICE"] = f"device:{args.cuda}"
    config.update({
        "WANDB_ENABLED": args.wandb,
        "NAME": args.name,
        "INFERENCE": args.inference,
        "SWEEP": args.sweep,
        "FOLDS": getattr(args, "folds", 0),
        "RESUME": getattr(args, "resume", None),
    })
    return config
