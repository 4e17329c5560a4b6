"""CAM method menu for the 3D ViT on the Grad-CAM probe layer.

Counterpart of ``neurovit_tpu/explainability/cam_methods.py`` (the
pytorch_grad_cam ViT tutorial's menu, gradcam_original.py:59-68, native on
the 3D ViT). Every method consumes the (activations, gradients) of the
probe (``gradcam_vit3d.probe_acts_grads``), computes its token-space map
and shares the CAM tail (ReLU -> per-sample norm -> percentile threshold ->
trilinear upsample).

Token-space conventions (CLS dropped): activations ``A[b, s, c]`` and
target-class gradients ``G[b, s, c]`` over the patch cells ``s`` and the
model's channels ``c``. Methods (pytorch_grad_cam semantics):

- ``gradcam``      w_c = mean_s G;             cam_s = sum_c w_c A
- ``gradcam++``    alpha from the 2nd-order expansion (Chattopadhay 2018)
- ``xgradcam``     w_c = sum_s(G*A)/(sum_s A + eps)
- ``layercam``     cam_s = sum_c relu(G)*A
- ``eigencam``     1st principal projection of spatially-centered A
- ``eigengradcam`` same, of G*A
- ``scorecam``     gradient-free: w_c = softmax_c score(x * upsample(A_c)),
                   the plain serving forward on the masked inputs
- ``ablationcam``  w_c = (score - score with channel c zeroed at the probe
                   layer) / score: the probe forward with the shift
                   -A[..., c] e_c (K6's forward, no backward)
- ``gradcam-ref``  the reference's own variant (gradcam_vit3d)

The forward methods run under ``torch.inference_mode()``, ``score_batch``
channels per forward. One deliberate difference from JAX: the orientation
of the principal projections (``eigencam``, ``eigengradcam`` and
``eigen_smooth``), which JAX takes from rounding noise
(``_principal_projection``). JAX's measured caveat holds here too: the probe layer
is a signed LayerNorm output, and on the trained cube task the robust
localizers are ``gradcam-ref``, ``layercam`` and ``scorecam``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neurovit_tpu_torch.explainability.gradcam_vit3d import (
    as_batch, finalize_cam, probe_acts_grads, to_numpy, token_grid_to_volume)

GRAD_METHODS = ("gradcam", "gradcam++", "xgradcam", "layercam",
                "eigencam", "eigengradcam")
FORWARD_METHODS = ("scorecam", "ablationcam")
METHODS = GRAD_METHODS + FORWARD_METHODS + ("gradcam-ref",)


def _principal_projection(x: torch.Tensor) -> torch.Tensor:
    """[B, S, C] -> [B, S]: projection onto the first right singular vector
    of the spatially-centered matrix (pytorch_grad_cam get_2d_projection).

    The singular vector's sign is arbitrary, and the tail ReLUs, so the
    orientation decides which half of the map survives. JAX orients by the
    sign of sum(relu(p) - relu(-p)) = sum(p), but the projection of
    spatially-centered rows sums to zero over s, so that sign is rounding
    noise (ROADMAP.md, Queue 3). Here the entry of largest magnitude is
    made positive: the map's strongest response survives the ReLU, and the
    same input gives the same map on every device."""
    centered = x - x.mean(dim=1, keepdim=True)
    _, _, vh = torch.linalg.svd(centered, full_matrices=False)
    proj = torch.einsum("bsc,bc->bs", centered, vh[:, 0, :])
    peak = proj.gather(1, proj.abs().argmax(dim=1, keepdim=True))
    return proj * torch.where(peak < 0, -1.0, 1.0)


def _token_cam(method: str, acts: torch.Tensor, grads: torch.Tensor,
               eigen_smooth: bool = False) -> torch.Tensor:
    """[B, S, C] activations and gradients -> [B, S] raw token map.
    ``eigen_smooth`` (the tutorial's flag) projects the weighted
    activations onto their first principal component in place of the
    channel sum; the eigen methods are projections already."""
    a, g = acts, grads
    if method == "eigencam":
        return _principal_projection(a)
    if method == "eigengradcam":
        return _principal_projection(g * a)
    if method == "gradcam":
        weighted = g.mean(dim=1, keepdim=True) * a
    elif method == "gradcam++":
        # alpha_sc = g^2 / (2 g^2 + (sum_s A) g^3) (Chattopadhay 2018 eq. 19).
        g2, g3 = g * g, g * g * g
        denom = 2.0 * g2 + a.sum(dim=1, keepdim=True) * g3
        alpha = torch.where(denom.abs() > 1e-12, g2 / denom,
                            torch.zeros_like(denom))
        w = (alpha * torch.relu(g)).sum(dim=1, keepdim=True)
        weighted = w * a
    elif method == "xgradcam":
        w = ((g * a).sum(dim=1, keepdim=True)
             / (a.sum(dim=1, keepdim=True) + 1e-8))
        weighted = w * a
    elif method == "layercam":
        weighted = torch.relu(g) * a
    else:
        raise ValueError(f"unknown gradient CAM method: {method}")
    if eigen_smooth:
        return _principal_projection(weighted)
    return weighted.sum(dim=2)


def _grad_cam_raw(model, x: torch.Tensor, method: str, eigen_smooth: bool):
    """Raw patch-grid CAM [B, cs, cs, cs] (volume order) and class_idx."""
    cs = model.vit_cfg.image_size // model.vit_cfg.image_patch_size
    _, class_idx, acts, grads = probe_acts_grads(model, x)
    cam = _token_cam(method, acts[:, 1:], grads[:, 1:], eigen_smooth)
    return token_grid_to_volume(cam.reshape(x.shape[0], cs, cs, cs)), \
        class_idx


# --------------------------------------------------------------------------
# Forward-only methods
# --------------------------------------------------------------------------

def _probe_forward(model, x: torch.Tensor):
    """(logits, f32 probe activations) of a zero-shift probe forward."""
    cfg = model.vit_cfg
    zeros = torch.zeros((x.shape[0], cfg.num_patches + 1, cfg.dim),
                        device=x.device)
    logits, acts = model.probe(x, zeros)
    return logits, acts.float()


def _channel_masks_hwd(acts_chunk: torch.Tensor, cs: int,
                       grid: int) -> torch.Tensor:
    """[K, S] token activations -> [K, H, W, D] min-max normalized input
    masks: upsampled on the (d, h, w) token grid, then transposed to the
    input's (h, w, d) order."""
    k = acts_chunk.shape[0]
    masks = acts_chunk.reshape(k, 1, cs, cs, cs)               # (k, d, h, w)
    masks = F.interpolate(masks, size=(grid, grid, grid), mode="trilinear",
                          align_corners=False)[:, 0]
    masks = masks.permute(0, 2, 3, 1)                          # (k, h, w, d)
    lo = masks.amin(dim=(1, 2, 3), keepdim=True)
    hi = masks.amax(dim=(1, 2, 3), keepdim=True)
    return (masks - lo) / (hi - lo + 1e-8)


def _forward_cam_raw(model, x: torch.Tensor, method: str, score_batch: int,
                     eigen_smooth: bool):
    """ScoreCAM / AblationCAM: raw patch-grid CAM and class_idx, with
    dim / score_batch forwards of ``score_batch`` volumes per sample."""
    cfg = model.vit_cfg
    grid, dim = cfg.image_size, cfg.dim
    cs = grid // cfg.image_patch_size
    logits, acts = _probe_forward(model, x)
    class_idx = logits.argmax(dim=1)
    # Pad the channel axis to whole chunks: one batch shape per model.
    n_chunks = -(-dim // score_batch)
    pad = n_chunks * score_batch - dim
    cams = []
    for i in range(x.shape[0]):
        x1, cls = x[i:i + 1], int(class_idx[i])
        scores = []
        if method == "scorecam":
            a_tok = F.pad(acts[i, 1:, :].t(), (0, 0, 0, pad))     # [C, S]
            for c0 in range(0, dim + pad, score_batch):
                masks = _channel_masks_hwd(a_tok[c0:c0 + score_batch], cs,
                                           grid)
                scores.append(model(x1 * masks)[:, cls])
            w = torch.softmax(torch.cat(scores)[:dim], dim=0)       # [C]
        else:                                                  # ablationcam
            acts1 = acts[i:i + 1]
            chan = F.pad(torch.arange(dim, device=x.device), (0, pad))
            for c0 in range(0, dim + pad, score_batch):
                onehot = F.one_hot(chan[c0:c0 + score_batch], dim).float()
                shifts = -acts1 * onehot[:, None, :]              # [K, T, C]
                xk = x1.expand((shifts.shape[0],) + x1.shape[1:])
                scores.append(model.probe(xk, shifts)[0][:, cls])
            ablated = torch.cat(scores)[:dim]
            base = logits[i, cls]
            # w_c = (score - ablated) / score, signed (upstream AblationCAM).
            safe = base if abs(float(base)) > 1e-8 else (
                base.new_tensor(-1e-8 if float(base) < 0 else 1e-8))
            w = (base - ablated) / safe                             # [C]
        weighted = w[None, None, :] * acts[i:i + 1, 1:, :]          # [1, S, C]
        cams.append(_principal_projection(weighted)[0] if eigen_smooth
                    else weighted[0].sum(dim=1))
    cam = torch.stack(cams)
    return token_grid_to_volume(cam.reshape(x.shape[0], cs, cs, cs)), \
        class_idx


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def compute_cam(model, x, method: str = "gradcam",
                threshold: Optional[float] = None, score_batch: int = 32,
                aug_smooth: bool = False, eigen_smooth: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """CAM of ``x`` ([B, H, W, D] or [H, W, D]) by any menu method:
    ``(cam_3d, class_idx)`` with ``get_attention_map``'s squeeze.

    ``score_batch`` bounds the channels per forward of the forward-only
    methods (the tutorial's ``cam.batch_size = 32``). ``aug_smooth``
    averages the raw patch-grid CAM over the horizontal flip x intensity
    {0.9, 1.0, 1.1} augmentations (flipped CAMs flipped back) and runs the
    tail once on the average; ``eigen_smooth`` projects weighted
    activations onto their first principal component (``_token_cam``)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "gradcam-ref":
        if aug_smooth or eigen_smooth:
            raise ValueError("gradcam-ref reproduces the reference's own "
                             "pipeline, which has no smoothing flags")
        from neurovit_tpu_torch.explainability.gradcam_vit3d import \
            get_attention_map
        return get_attention_map(model, x, threshold=threshold)
    if threshold is None:
        threshold = float(model.config["GRADCAM_THRESHOLD"])
    x, squeeze = as_batch(model, x)

    def raw_cam(xv):
        if method in GRAD_METHODS:
            return _grad_cam_raw(model, xv, method, eigen_smooth)
        with torch.inference_mode():
            return _forward_cam_raw(model, xv, method, score_batch,
                                    eigen_smooth)

    cam, class_idx = raw_cam(x)
    if aug_smooth:
        cams = [cam]
        for flip in (False, True):
            for scale in (0.9, 1.0, 1.1):
                if not flip and scale == 1.0:
                    continue            # identity: already computed
                xi = x * scale
                if flip:
                    xi = xi.flip(2)
                cam_i, _ = raw_cam(xi)
                cams.append(cam_i.flip(2) if flip else cam_i)
        cam = torch.stack(cams).mean(dim=0)
    cam = finalize_cam(cam, model.vit_cfg.image_size, float(threshold))
    return to_numpy(cam, class_idx, squeeze)
