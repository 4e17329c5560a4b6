"""Volume transforms (host-side, numpy).

The port's copy of ``neurovit_tpu/data/transforms.py``.
Replaces the reference's monai ``RandSpatialCrop(roi_size=(80,80,80))``
(``DatasetADNI.py:27-31``). Note the reference quirk (SURVEY §2.1.13): its
hardcoded 80-cube is incompatible with TRAINING_VIT_INPUT_SIZE=90 patchify
asserts, so the flag only worked disabled. Here the crop size defaults to the
model input size (pad if needed), making DATASET_TRANSFORMS actually usable.
"""

from __future__ import annotations

import numpy as np


def zscore(volume: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Per-volume z-score with the reference's epsilon (DatasetADNI.py:213)."""
    volume = np.asarray(volume, dtype=np.float32)
    return (volume - volume.mean()) / (volume.std() + eps)


def rand_spatial_crop(volume: np.ndarray, roi: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Random spatial crop to (roi, roi, roi) with random center; pads with
    zeros when an axis is smaller than roi (monai RandSpatialCrop semantics,
    random_size=False)."""
    out = volume
    pads = [(0, max(0, roi - s)) for s in out.shape[:3]]
    if any(p[1] for p in pads):
        out = np.pad(out, pads + [(0, 0)] * (out.ndim - 3))
    starts = [rng.randint(0, s - roi + 1) for s in out.shape[:3]]
    sl = tuple(slice(st, st + roi) for st in starts)
    return out[sl]
