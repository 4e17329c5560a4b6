"""G3D-ViT Grad-CAM: attention-gradient class activation maps, hook-free.

Counterpart of ``neurovit_tpu/explainability/gradcam_vit3d.py`` (the
reference's ``NeuroEncoder.get_attention_map`` / ``visualize_slice``,
``src/models/NeuroEncoder.py:84-168``). The reference captures the
LayerNorm output inside the last attention block with forward and backward
hooks and a one-hot ``backward()``; here, as in JAX, the model exposes a
probe: a zeros tensor added at that LayerNorm output (``NeuroEncoder.probe``)
whose gradient, from ``torch.autograd.grad``, is the hook's gradient.

The CAM tail keeps JAX's operations: grad mean over features, weighted
activation sum, CLS drop, the token grid rendered in volume axis order
(``token_grid_to_volume``, JAX's deliberate fix of the reference's axis
order), ReLU, per-sample min-max normalization, the percentile threshold
(``torch.quantile`` with linear interpolation, as ``jnp.percentile``) and
the upsample (``F.interpolate(align_corners=False)``, which for an upsample
equals ``jax.image.resize``'s trilinear / bilinear).

Everything runs on the model's device; the public functions return numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def as_batch(model, x) -> Tuple[torch.Tensor, bool]:
    """Volumes [B, H, W, D] or one [H, W, D] (numpy or tensor) as an f32
    tensor [B, H, W, D] on the model's device, and whether a batch axis was
    added."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    x = x.to(model_device(model), torch.float32)
    return (x[None], True) if x.ndim == 3 else (x, False)


def to_numpy(cam: torch.Tensor, class_idx: torch.Tensor, squeeze: bool):
    """The public return value: numpy arrays, a batch of one squeezed to
    the single map (the reference's ``.squeeze()``)."""
    cam = cam.detach().float().cpu().numpy()
    if squeeze or cam.shape[0] == 1:
        cam = cam[0]
    return cam, class_idx.detach().cpu().numpy()


def token_grid_to_volume(cam: torch.Tensor) -> torch.Tensor:
    """[B, *token_grid] -> [B, *volume] axis order for a 3D patch-grid CAM.
    The encoder permutes the [B, X, Y, Z] volume to [B, 1, Z, X, Y] before
    patchify, so a token-grid CAM is (z, x, y)-ordered; this is the inverse
    permute (gradcam_vit3d.py:28-44 gives the measurement behind it)."""
    return cam.permute(0, 2, 3, 1)


def finalize_cam(cam: torch.Tensor, grid: int,
                 threshold: float) -> torch.Tensor:
    """The CAM tail (NeuroEncoder.py:117-131): ReLU -> per-sample min-max
    norm -> percentile threshold -> trilinear upsample to [B, grid^3]."""
    return finalize_cam_nd(cam, (grid, grid, grid), threshold,
                           method="trilinear")


def finalize_cam_nd(cam: torch.Tensor, out_shape, threshold: float,
                    method: str) -> torch.Tensor:
    """Rank-agnostic CAM tail: [B, *patch_grid] -> [B, *out_shape]. Every
    reduction is per sample, so a batched call equals single calls."""
    b = cam.shape[0]
    dims = tuple(range(1, cam.ndim))
    cam = torch.relu(cam.float())
    cam_min = cam.amin(dim=dims, keepdim=True)
    cam_max = cam.amax(dim=dims, keepdim=True)
    cam = (cam - cam_min) / (cam_max - cam_min + 1e-8)
    # Keep the top `threshold`% (np.percentile(cam, 100 - t), :121-123).
    value = torch.quantile(cam.reshape(b, -1), (100.0 - threshold) / 100.0,
                           dim=1, interpolation="linear")
    cam = torch.where(cam >= value.reshape((b,) + (1,) * len(dims)), cam,
                      torch.zeros((), device=cam.device))
    return F.interpolate(cam[:, None], size=tuple(out_shape), mode=method,
                         align_corners=False)[:, 0]


def probe_acts_grads(model, x: torch.Tensor):
    """One probe forward and backward: (logits, class_idx, activations,
    gradients). ``activations`` and ``gradients`` are the last attention
    block's LayerNorm output and its gradient with respect to the
    argmax-class logit (NeuroEncoder.py:70-82,94-98), f32 [B, N + 1, dim],
    CLS token included. x: f32 [B, H, W, D] on the model's device."""
    cfg = model.vit_cfg
    shift = torch.zeros((x.shape[0], cfg.num_patches + 1, cfg.dim),
                        device=x.device, requires_grad=True)
    with torch.enable_grad():
        logits, acts = model.probe(x, shift)
        class_idx = logits.argmax(dim=1)
        # The one-hot cotangent, built on the device without a host sync.
        one_hot = torch.zeros_like(logits).scatter_(1, class_idx[:, None], 1.0)
        (grads,) = torch.autograd.grad(logits, shift, grad_outputs=one_hot)
    return logits.detach(), class_idx, acts.detach().float(), grads


def raw_attention_map(model, acts: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """The reference's raw CAM of probe activations and gradients [B, N + 1,
    dim]: the mean gradient over the features weights the activations
    (:103), summed over the features, CLS dropped (:112), as a patch grid
    [B, cs, cs, cs] in volume axis order."""
    cs = model.vit_cfg.image_size // model.vit_cfg.image_patch_size
    cam = (grads.mean(dim=2, keepdim=True) * acts).sum(dim=2)[:, 1:]
    return token_grid_to_volume(cam.reshape(acts.shape[0], cs, cs, cs))


def attention_map(model, x: torch.Tensor, threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: f32 [B, H, W, D] on the model's device -> (cam [B, grid, grid,
    grid] f32, class_idx [B]), tensors on that device
    (``_attention_map_jit``)."""
    _, class_idx, acts, grads = probe_acts_grads(model, x)
    cam = raw_attention_map(model, acts, grads)
    return finalize_cam(cam, model.vit_cfg.image_size, threshold), class_idx


def get_attention_map(model, x, threshold: Optional[float] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``NeuroEncoder.get_attention_map`` (x: [B, H, W, D] or [H, W, D]):
    (cam_3d, class_idx) as numpy; for B = 1 the cam is squeezed to
    [grid]^3. ``threshold`` overrides the config's GRADCAM_THRESHOLD
    (percent of voxels kept)."""
    if threshold is None:
        threshold = float(model.config["GRADCAM_THRESHOLD"])
    x, squeeze = as_batch(model, x)
    cam, class_idx = attention_map(model, x, float(threshold))
    return to_numpy(cam, class_idx, squeeze)


def reshape_transform(tokens, depth: int, height: int, width: int,
                      slice_idx: Optional[int] = None) -> torch.Tensor:
    """ViT token stream [B, 1 + depth*height*width, dim] -> CNN-style 2D
    feature map [B, dim, height, width]: CLS dropped, tokens folded into the
    patch grid, one depth slice (the middle one by default), channels first
    (gradcam_sMRI.py:16-29)."""
    tokens = torch.as_tensor(tokens)
    b, _, dim = tokens.shape
    grid = tokens[:, 1:, :].reshape(b, depth, height, width, dim)
    if slice_idx is None:
        slice_idx = depth // 2
    return grid[:, slice_idx].permute(0, 3, 1, 2)


def visualize_slice(config: Dict, cam_3d, original_volume):
    """The (image, attention) slice pair along GRADCAM_SLICE_DIM at
    GRADCAM_SLICE_IDX (NeuroEncoder.py:135-168), as numpy."""
    slice_dim = config["GRADCAM_SLICE_DIM"]
    slice_idx = config["GRADCAM_SLICE_IDX"]
    if cam_3d is None:
        print("Error: No CAM computed")
        return None
    original = np.asarray(original_volume).squeeze()
    cam_3d = np.asarray(cam_3d)
    if original.ndim != 3 or cam_3d.ndim != 3:
        print(f"Shape mismatch: original {original.shape}, CAM {cam_3d.shape}")
        return None
    if slice_dim == 0:      # Sagittal
        return original[slice_idx], cam_3d[slice_idx]
    if slice_dim == 1:      # Coronal
        return original[:, slice_idx], cam_3d[:, slice_idx]
    if slice_dim == 2:      # Axial
        return original[:, :, slice_idx], cam_3d[:, :, slice_idx]
    print(f"Invalid slice dimension: {slice_dim}")
    return None
