"""4D frozen-feature cache: encode every sequence once, train on features.

Counterpart of ``neurovit_tpu/training/feature_cache.py``. In 4D the volume
encoder is frozen, runs in eval and draws no dropout, and the 4D datasets
apply no random transform, so each sequence's encodings ([T, num_classes]
f32, about 1 KB) are the same every epoch. ``TRAINING_4D_FEATURE_CACHE:
true`` encodes the corpus once (:func:`precompute`) and every epoch trains
the temporal head and the projection on the cached features
(``NeuroEncoder.apply_features``, the same tail the full forward runs, on
the same seed stream). The precompute pass runs through the trainer's int8
copy of the encoder when ``TRAINING_4D_ENCODER_QUANT: int8`` is on, so the
cached features are what the uncached int8 path trains on.

A failed sample read is cached as ``None`` and skipped by the DataLoader as
the volume path skips it.

``TRAINING_4D_FEATURE_CACHE_DIR`` persists the views as npz files (no
pickle) keyed by :func:`fingerprint`: a restarted process reloads them
instead of encoding the corpus again, and a file written for other encoder
weights, another quant mode or another corpus is ignored.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from neurovit_tpu_torch.data.loader import DataLoader


class FeatureView:
    """In-memory dataset of cached per-sequence features for the DataLoader:
    ``sample(idx)`` returns the [T, C] features under ``"volume"``, so
    batching, shuffling, padding and the valid mask are the volume
    loader's."""

    def __init__(self, feats: List[Optional[np.ndarray]], labels: List[int],
                 subjects: List[Any]):
        self.feats = feats
        self.labels = labels
        self.subjects = subjects

    def __len__(self) -> int:
        return len(self.feats)

    def sample(self, idx: int) -> Optional[Dict[str, Any]]:
        feat = self.feats[idx]
        if feat is None:                 # failed read at precompute time
            return None
        return {"volume": feat, "label": self.labels[idx],
                "subject": self.subjects[idx]}

    __getitem__ = sample


def dataset_identity(dataset) -> str:
    """A dataset's identity for the persisted cache's key
    (feature_cache.py:79-101): ``cache_identity`` when the dataset has one;
    else its type and length, a hash of its ``data`` rows (the 4D ADNI
    index) and its ``dataset_path``."""
    ident = getattr(dataset, "cache_identity", None)
    if ident is not None:
        return f"custom:{ident}"
    parts = [type(dataset).__name__, f"n={len(dataset)}"]
    rows = getattr(dataset, "data", None)
    if rows is not None:
        parts.append("rows=" + hashlib.sha256(
            str(rows).encode()).hexdigest()[:16])
    path = getattr(dataset, "dataset_path", None)
    if path is not None:
        parts.append(f"path={path}")
    return ";".join(parts)


@torch.no_grad()
def fingerprint(encoder, quant4d: bool, dataset) -> str:
    """The persisted view's key: a hash of the frozen encoder's state (the
    f32 sum of every parameter and buffer, taken on its device and fetched
    once, with each entry's name, shape and dtype), the quant mode (the int8
    copy derives from these weights) and :func:`dataset_identity`.
    ``encoder``: the module, or its whole state dict (a tensor-parallel
    rank's, gathered)."""
    state = encoder if isinstance(encoder, dict) else encoder.state_dict()
    sums = torch.stack([v.float().sum() for v in state.values()])
    h = hashlib.sha256()
    h.update(sums.cpu().numpy().astype(np.float32).tobytes())
    for name, v in state.items():
        h.update(str((name, tuple(v.shape), str(v.dtype))).encode())
    h.update(f"quant={bool(quant4d)};ds={dataset_identity(dataset)}"
             .encode())
    return h.hexdigest()[:16]


def save_view(path: str, view: FeatureView, fp: str) -> None:
    """Write ``view`` as npz: the fingerprint, which slots are filled, the
    stacked features, labels and subjects (as strings). A per-process
    temporary name, then an atomic rename."""
    ok = np.array([f is not None for f in view.feats], np.bool_)
    feats = (np.stack([f for f in view.feats if f is not None])
             if ok.any() else np.zeros((0, 1, 1), np.float32))
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, fp=np.array(fp), ok=ok, feats=feats,
             labels=np.asarray(view.labels, np.int64),
             subjects=np.asarray([str(s) for s in view.subjects]))
    os.replace(tmp, path)


def load_view(path: str, fp: str) -> Optional[FeatureView]:
    """The view persisted at ``path``; None when the file is absent,
    unreadable or written under another fingerprint."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["fp"]) != fp:
                return None
            ok = z["ok"]
            stacked = z["feats"]
            labels = [int(v) for v in z["labels"]]
            subjects = [str(s) for s in z["subjects"]]
    except Exception as e:
        print(f"[4D FEATURE CACHE] ignoring unreadable cache {path} "
              f"({type(e).__name__}: {e}); re-encoding")
        return None
    feats: List[Optional[np.ndarray]] = []
    j = 0
    for is_ok in ok:
        feats.append(stacked[j] if is_ok else None)
        j += int(is_ok)
    return FeatureView(feats, labels, subjects)


class _IndexedView:
    """Tags each sample with its index, so a batch's features land in
    their FeatureView slots (failed reads stay None at theirs)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def sample(self, idx: int) -> Optional[Dict[str, Any]]:
        s = self.dataset.sample(idx)
        if s is None:
            return None
        return {"volume": s["volume"], "label": s["label"],
                "subject": s.get("subject", str(idx)), "cache_index": idx}

    __getitem__ = sample


def precompute(model, dataset, *, batch_size: int = 1, num_workers: int = 8,
               host_bf16: bool = False, encoder=None,
               quiet: bool = False) -> FeatureView:
    """One pass of ``model.encode_sequence`` over ``dataset`` on the
    model's device -> a FeatureView of [T, C] f32 encodings. Sequences come
    through the DataLoader (threaded reads, bounded prefetch) in batches of
    ``batch_size``, B·T volumes an encoder call; ``host_bf16`` casts each
    batch to bf16 on the host (the trainer's TRAINING_HOST_TRANSFER_DTYPE);
    ``encoder`` is the trainer's int8 copy, if any. Inside a
    data-parallel ``parallel.use_mesh`` every rank runs the whole pass and
    ``encode_sequence`` splits each batch's stream over the ranks (each JAX
    host encodes the full dataset too, trainer.py:460-467); ``quiet``
    leaves out the summary line (the ranks after 0)."""
    device = next(model.parameters()).device
    t0 = time.time()
    n = len(dataset)
    feats: List[Optional[np.ndarray]] = [None] * n
    labels: List[int] = [0] * n
    subjects: List[Any] = [f"failed-{i}" for i in range(n)]
    loader = DataLoader(_IndexedView(dataset), max(1, batch_size),
                        shuffle=False, num_workers=num_workers)
    n_ok = 0
    for batch in loader:
        x = torch.from_numpy(np.ascontiguousarray(batch["volume"],
                                                  np.float32))
        if host_bf16:
            x = x.to(torch.bfloat16)
        if device.type == "cuda":
            x = x.pin_memory()
        enc = model.encode_sequence(x.to(device, non_blocking=True),
                                    encoder=encoder).cpu().numpy()
        for row, ok in enumerate(batch["valid"]):
            if not ok:                    # tail padding
                continue
            idx = batch["cache_index"][row]
            feats[idx] = enc[row]
            labels[idx] = int(batch["label"][row])
            subjects[idx] = batch["subject"][row]
            n_ok += 1
    if not quiet:
        print(f"[4D FEATURE CACHE] encoded {n_ok} sequences once "
              f"({n - n_ok} failed reads masked) in "
              f"{time.time() - t0:.1f}s; epochs now train the temporal "
              "head on cached features")
    return FeatureView(feats, labels, subjects)
