"""Checkpoints: the full train state, and weights for interchange.

Counterpart of ``neurovit_tpu/training/checkpoint.py``:

- :func:`save_train_state` writes ``torch.save`` of the model and optimizer
  state dicts, the epoch, the trainer's generator state (the dropout seed
  stream) and the plateau counters at ``path``, for a true resume, plus the
  weights alone at ``<path>.state_dict.pkl`` under the reference's keys
  (checkpoint.py:36-62), which the JAX package loads;
- :func:`save_last_model`: the rolling weights-only save
  (checkpoint.py:89-94, the reference's ``Trainer.py:54``);
- :func:`load_checkpoint`: the inference load (``load_variables_file``,
  checkpoint.py:116; the reference's main.py:166-170), ``strict=False`` by
  default.

The JAX package's asynchronous Orbax save has no counterpart yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn as tnn

from neurovit_tpu_torch.training import state_dict as sd

LAST_MODEL_PATH = "./results/last_model.pkl"  # reference: ./results/last_model.pth


def save_train_state(path: str, state: Dict[str, Any],
                     model: tnn.Module) -> None:
    """Write the train state ``state`` (a dict of state dicts, tensors and
    numbers) at ``path`` and the model's weights at
    ``<path>.state_dict.pkl``. The train state goes to a temporary name
    first, so an interrupted save leaves no partial file under ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    partial = path + ".partial"
    torch.save(state, partial)
    os.replace(partial, path)
    sd.save(path + ".state_dict.pkl", model.state_dict())


def load_train_state(path: str) -> Dict[str, Any]:
    """Read what :func:`save_train_state` wrote at ``path`` onto the CPU.
    ``weights_only``: state dicts, tensors and numbers only."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def save_last_model(model: tnn.Module, path: str = LAST_MODEL_PATH) -> None:
    """Rolling weights-only save (reference Trainer.py:54)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd.save(path, model.state_dict())


def load_checkpoint(model: tnn.Module, path: str, strict: bool = False):
    """Load the state-dict file at ``path`` into ``model`` in place.
    ``strict=False`` skips missing and unknown keys; a shape mismatch
    raises either way. Returns torch's (missing_keys, unexpected_keys)."""
    return model.load_state_dict(sd.load(path), strict=strict)
