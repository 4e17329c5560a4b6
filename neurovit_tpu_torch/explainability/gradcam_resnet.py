"""ResNet CAMs: GradCAM, GradCAM-elementwise and LayerCAM on layer4.

Counterpart of ``neurovit_tpu/explainability/gradcam_resnet.py`` (the
reference's pytorch_grad_cam use,
``explainability/xAi_gradcam_Resnet3D/gradcam.py:8,29-30``: LayerCAM, with
GradCAM and GradCAMElementWise as alternatives, on ``resnet.layer4[-1]``).
The layer4 activations and their gradients come from the ResNet's probe:
a zeros shift added to the layer4 output, whose gradient from
``torch.autograd.grad`` of the argmax-class logit is the hook's gradient.
The body before layer4's output records no graph unless the volume
requires grad, so a CAM launches the pool's forward kernel and no
backward kernel. The tail keeps JAX's operations: channel weighting, ReLU,
per-sample min-max normalization, the trilinear upsample to the volume
(``F.interpolate(align_corners=False)``, which for an upsample equals
``jax.image.resize``'s trilinear, edges included) and the permute back to
the volume's [H, W, D] order.

Everything runs on the model's device; ``resnet_cam`` returns numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neurovit_tpu_torch.explainability.gradcam_vit3d import as_batch

METHODS = ("gradcam", "gradcam_elementwise", "layercam")


def layer4_acts_grads(model, x: torch.Tensor):
    """(logits, class_idx, activations, gradients) of the layer4 output
    [B, C', D', H', W'], f32, for x: f32 [B, H, W, D] on the model's
    device; the gradients are of each volume's argmax-class logit."""
    resnet = model.resnet_3d.resnet
    vol = x.permute(0, 3, 1, 2)[:, None].to(model.compute_dtype)
    with torch.set_grad_enabled(x.requires_grad):
        features = resnet.body(vol, train=False)
    shift = torch.zeros(features.shape, dtype=torch.float32,
                        device=x.device, requires_grad=True)
    with torch.enable_grad():
        shifted = features + shift.to(features.dtype)
        logits = resnet.head(shifted)
        class_idx = logits.argmax(dim=1)
        one_hot = torch.zeros_like(logits).scatter_(1, class_idx[:, None], 1.0)
        (grads,) = torch.autograd.grad(logits, shift, grad_outputs=one_hot)
    return logits.detach(), class_idx, shifted.detach().float(), grads


def raw_cam(method: str, acts: torch.Tensor,
            grads: torch.Tensor) -> torch.Tensor:
    """The method's channel-weighted map [B, D', H', W'], before the ReLU."""
    if method == "gradcam":
        w = grads.mean(dim=(2, 3, 4), keepdim=True)
        return (w * acts).sum(dim=1)
    if method == "gradcam_elementwise":
        return torch.relu(grads * acts).sum(dim=1)
    if method == "layercam":
        return (torch.relu(grads) * acts).sum(dim=1)
    raise ValueError(f"unknown CAM method {method!r} (supported: "
                     f"{', '.join(METHODS)})")


def cam_to_volume(cam: torch.Tensor, volume_shape) -> torch.Tensor:
    """ReLU, per-sample min-max normalization, the trilinear upsample of
    [B, D', H', W'] to the volume's (D, H, W), and the permute to [B, H, W,
    D]; ``volume_shape`` is (H, W, D)."""
    cam = torch.relu(cam)
    flat = cam.reshape(cam.shape[0], -1)
    lo = flat.amin(dim=1).reshape(-1, 1, 1, 1)
    hi = flat.amax(dim=1).reshape(-1, 1, 1, 1)
    cam = (cam - lo) / (hi - lo + 1e-8)
    h, w, d = volume_shape
    cam = F.interpolate(cam[:, None], size=(d, h, w), mode="trilinear",
                        align_corners=False)[:, 0]
    return cam.permute(0, 2, 3, 1)


def cam(model, x: torch.Tensor, method: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: f32 [B, H, W, D] on the model's device -> (cam [B, H, W, D] in
    [0, 1], class_idx [B]), tensors on that device (``_resnet_cam_jit``)."""
    _, class_idx, acts, grads = layer4_acts_grads(model, x)
    return cam_to_volume(raw_cam(method, acts, grads), x.shape[1:]), class_idx


def resnet_cam(model, x, method: str = "layercam"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """x: [H, W, D] or [B, H, W, D] -> (cam, class_idx) as numpy; LayerCAM
    by default, the reference's choice (gradcam.py:30). A single volume's
    cam is [H, W, D]. The model holds its weights and BN state, so this
    takes no ``variables``."""
    x, squeeze = as_batch(model, x)
    out, class_idx = cam(model, x, method)
    out = out.detach().float().cpu().numpy()
    return (out[0] if squeeze else out), class_idx.cpu().numpy()
