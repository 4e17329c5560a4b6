"""Kernel SHAP over cube superpixels for the volume classifier.

Counterpart of ``neurovit_tpu/explainability/shap_values.py``: the volume
is cut into cube regions (M = (grid / region)^3 features); coalitions are
drawn from ``np.random.RandomState(seed)`` exactly as in JAX, so the two
packages evaluate the same coalitions; disabled regions take the background
value; the model scores every coalition volume (batched serving forwards on
the model's device); a weighted least squares under the Shapley kernel
gives per-region values.
"""

from __future__ import annotations

from math import comb
from typing import Optional, Tuple

import numpy as np
import torch

from neurovit_tpu_torch.explainability.gradcam_vit3d import model_device


def _shapley_kernel_weights(m: int, sizes: np.ndarray) -> np.ndarray:
    """pi(z) = (M-1) / (C(M,|z|) |z| (M-|z|)); the infinite endpoints get a
    large weight. The denominator is an exact integer: the JAX function
    multiplies it by the float32 size, which overflows to inf (a weight of
    0) for coalitions of about half of M >= 120 regions."""
    w = np.empty(len(sizes))
    for i, s in enumerate(int(s) for s in sizes):
        if s == 0 or s == m:
            w[i] = 1e6
        else:
            w[i] = (m - 1) / (comb(m, s) * s * (m - s))
    return w


def kernel_shap(model, x, *, region_size: Optional[int] = None,
                nsamples: int = 256, background: float = 0.0,
                batch_size: int = 32, seed: int = 0
                ) -> Tuple[np.ndarray, int]:
    """x: [H, W, D] -> (shap_values [H, W, D] broadcast from the regions,
    class_idx). The values explain the argmax-class logit relative to the
    background volume."""
    x = np.asarray(x, np.float32)
    grid = x.shape[0]
    region = min(region_size or model.config.get("GRADCAM_CUBE_SIZE", 8),
                 grid)
    if grid % region:
        # The JAX function's coalition masks cover only n_side * region
        # voxels a side and then fail to broadcast against the volume.
        raise ValueError(f"region_size {region} must divide the volume side "
                         f"{grid}")
    n_side = grid // region
    m = n_side ** 3
    device = model_device(model)

    def predict(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(batch).to(device)).cpu().numpy()

    class_idx = int(np.argmax(predict(x[None])[0]))

    rng = np.random.RandomState(seed)
    # Coalition matrix: always include the empty and full coalitions.
    z = rng.randint(0, 2, size=(nsamples, m)).astype(np.float32)
    z[0] = 0.0
    z[1] = 1.0

    def to_voxel_mask(zrow):
        cube = zrow.reshape(n_side, n_side, n_side)
        return np.kron(cube, np.ones((region, region, region), np.float32))

    scores = np.empty(nsamples, np.float64)
    for start in range(0, nsamples, batch_size):
        rows = z[start:start + batch_size]
        vols = np.stack([
            np.where(to_voxel_mask(r) > 0, x, background)
            for r in rows]).astype(np.float32)
        scores[start:start + len(rows)] = predict(vols)[:, class_idx]

    weights = _shapley_kernel_weights(m, z.sum(axis=1))
    # Weighted least squares with intercept: scores ~ b0 + z @ phi.
    a = np.concatenate([np.ones((nsamples, 1)), z], axis=1)
    w = np.diag(weights)
    coef, *_ = np.linalg.lstsq(w @ a, w @ scores, rcond=None)
    phi = coef[1:]
    voxel_attr = np.kron(phi.reshape(n_side, n_side, n_side),
                         np.ones((region, region, region)))
    return voxel_attr.astype(np.float32), class_idx
