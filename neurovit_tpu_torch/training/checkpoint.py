"""Checkpoints: the full train state, and weights for interchange.

Counterpart of ``neurovit_tpu/training/checkpoint.py``:

- :func:`save_train_state` writes ``torch.save`` of the model and optimizer
  state dicts, the epoch, the trainer's generator state (the dropout seed
  stream) and the plateau counters at ``path``, for a true resume, plus the
  weights alone at ``<path>.state_dict.pkl`` under the reference's keys
  (checkpoint.py:36-62), which the JAX package loads; with
  ``asynchronous=True`` the train state's write overlaps the caller, and
  :func:`wait_for_async_saves` commits it (checkpoint.py:33-69);
- :func:`save_last_model`: the rolling weights-only save
  (checkpoint.py:89-94, the reference's ``Trainer.py:54``);
- :func:`load_checkpoint`: the inference load (``load_variables_file``,
  checkpoint.py:116; the reference's main.py:166-170), ``strict=False`` by
  default;
- :func:`load_pretrained_volume_encoder`: the 4D bootstrap
  (checkpoint.py:97-105), a 3D run's ViT weights into the frozen encoder.

In a multi-process run the trainer calls the writers on rank 0 alone and
the ranks meet at a barrier after each write; every rank reads.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
from torch import nn as tnn

from neurovit_tpu_torch.training import state_dict as sd

LAST_MODEL_PATH = "./results/last_model.pkl"  # reference: ./results/last_model.pth


# One writer thread with at most one save in flight (checkpoint.py:33):
# a save first waits for the one before it.
_writer: Optional[ThreadPoolExecutor] = None
_in_flight: Optional[Future] = None


def _host_copy(obj: Any) -> Any:
    """A deep copy of ``obj`` with every tensor copied to host memory, done
    when this returns: a CPU tensor is cloned (a state dict's entries alias
    the live parameters), a CUDA tensor is copied synchronously."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write(state: Dict[str, Any], path: str) -> None:
    partial = path + ".partial"
    torch.save(state, partial)
    os.replace(partial, path)


def _weights(model) -> Dict[str, torch.Tensor]:
    """A module's state dict, or the state dict given (a sharded model's
    whole one)."""
    return model if isinstance(model, dict) else model.state_dict()


def save_train_state(path: str, state: Dict[str, Any], model,
                     *, asynchronous: bool = False) -> None:
    """Write the train state ``state`` (a dict of state dicts, tensors and
    numbers) at ``path`` and the model's weights (``model``: the module or
    its state dict) at ``<path>.state_dict.pkl``. The train state goes to a
    temporary name first, so an interrupted save leaves no partial file
    under ``path``.

    The state is first copied to host memory, so the steps after this call
    may update the live tensors. ``asynchronous=True`` leaves the write of
    that copy and its rename to a writer thread, overlapping the caller;
    call :func:`wait_for_async_saves` before reading the checkpoint back or
    exiting. The weights file is written before this returns either way."""
    global _writer, _in_flight
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    snapshot = _host_copy(state)
    if asynchronous:
        wait_for_async_saves()
        if _writer is None:
            _writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
        _in_flight = _writer.submit(_write, snapshot, path)
    else:
        _write(snapshot, path)
    sd.save(path + ".state_dict.pkl", _weights(model))


def wait_for_async_saves() -> None:
    """Block until the asynchronous save in flight, if any, has been
    written and renamed; raise its error here if it failed."""
    global _in_flight
    pending, _in_flight = _in_flight, None
    if pending is not None:
        pending.result()


def load_train_state(path: str) -> Dict[str, Any]:
    """Read what :func:`save_train_state` wrote at ``path`` onto the CPU.
    ``weights_only``: state dicts, tensors and numbers only."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def save_last_model(model, path: str = LAST_MODEL_PATH) -> None:
    """Rolling weights-only save (reference Trainer.py:54) of the module or
    its state dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd.save(path, _weights(model))


def load_checkpoint(model: tnn.Module, path: str, strict: bool = False):
    """Load the state-dict file at ``path`` into ``model`` in place.
    ``strict=False`` skips missing and unknown keys; a shape mismatch
    raises either way. Returns torch's (missing_keys, unexpected_keys)."""
    return model.load_state_dict(sd.load(path), strict=strict)


def load_pretrained_volume_encoder(model: tnn.Module, path: str):
    """4D bootstrap (checkpoint.py:97-105, the reference's
    NeuroEncoder.py:25-32): load only the ``volume_encoder.vit3d.`` keys of
    the state-dict file at ``path`` (the port's or the JAX package's) into
    ``model``, ``strict=False``; a shape mismatch raises. Returns torch's
    (missing_keys, unexpected_keys)."""
    weights = {k: v for k, v in sd.load(path).items()
               if k.startswith(sd.PREFIX)}
    return model.load_state_dict(weights, strict=False)
