"""2D ViT CAM tutorial: the pytorch_grad_cam ViT workflow on a 2D ViT.

Counterpart of ``neurovit_tpu/explainability/vit_cam_2d.py`` (the
reference's vendored upstream tutorial,
``explainability/activation_map/gradcam_original.py``): a 2D ViT, a CAM
method from the menu applied to the last block's first LayerNorm, the
197-token stream folded back into the 14x14 patch grid, and a jet overlay
PNG (gradcam_original.py:38-45,56-68,73,99).

- :class:`ViT2D` is the port's 3D ViT at ``frames=1, frame_patch_size=1``
  (image 56, patch 4: DeiT's 14x14 token grid at demo size), f32, on an
  explicit device (the card unless told otherwise). It holds its weights,
  as the port's ``NeuroEncoder`` does, in place of JAX's
  ``(model, variables)`` pair, and exposes what ``probe_acts_grads`` and
  the menu read: ``vit_cfg``, ``config["GRADCAM_THRESHOLD"]``,
  ``forward(x)`` and ``probe(x, shift)`` on [B, H, W] images.
- The demo model is trained in-process on synthetic squares
  (:func:`make_squares`, the cube dataset one dimension down), since the
  tutorial's pretrained DeiT is a download: each image has one bright
  square whose grid cell is the label, so a faithful CAM lights the square.
  The images follow JAX's rule but come from a ``torch.Generator``, not
  ``jax.random``'s draws.
- :func:`compute_cam_2d` runs every menu method but ``gradcam-ref``, with
  ``aug_smooth`` (the flip on axis 2) and ``eigen_smooth``, through the
  3D menu's own ``cam_methods.grid_cam`` on the 2D grid (:data:`IMAGE`):
  row-major tokens, bilinear ScoreCAM masks and a bilinear tail.
- :func:`show_cam_on_image` renders matplotlib's jet colormap from its
  segment table and the PNG is written by :func:`write_png` (zlib), so the
  CLI runs where matplotlib is absent; only ``--image-path`` reads an image
  file through ``matplotlib.image``.

On a card the probe runs K1-K4 at f32 in block 0 and K6 at f32 (forward,
and backward under the gradient) in the last block; training runs the f32
block forwards and backwards K1-K5 and K7-K9.

``python -m neurovit_tpu_torch.explainability.vit_cam_2d [--device cpu]``
trains the demo model and writes ``<method>_cam.png``.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from neurovit_tpu_torch.explainability import cam_methods
from neurovit_tpu_torch.explainability.gradcam_vit3d import finalize_cam_nd
from neurovit_tpu_torch.models.vit3d import ViT3D, ViTConfig
from neurovit_tpu_torch.training.optim import Optimizer
from neurovit_tpu_torch.training.state_dict import PREFIX, from_jax_params

# DeiT-tiny's geometry (224 / 16 -> 14x14 tokens) at demo size: 56 / 4 ->
# the same 14x14 grid, 197 tokens.
IMAGE_SIZE = 56
PATCH_SIZE = 4
SQUARE_SIZE = 14            # deliberately not a patch multiple
NUM_CLASSES = (IMAGE_SIZE // SQUARE_SIZE) ** 2
METHODS_2D = tuple(m for m in cam_methods.METHODS if m != "gradcam-ref")
# optax.adamw(3e-4, weight_decay=0.01), the JAX demo's optimizer.
DEMO_LR, DEMO_WEIGHT_DECAY = 3e-4, 0.01


class ViT2D(tnn.Module):
    """A 2D ViT as a single-frame 3D ViT: [B, H, W] images -> f32 logits.

    Depth 2, as JAX's: deeper stacks concentrate the class evidence in the
    CLS token on this task and the probe layer's tokens stop localizing
    (vit_cam_2d.py:66-72). The weights are drawn from ``seed`` as the
    port's ViT draws them (``ViT3D.reset_parameters``); :meth:`load_jax`
    takes JAX's instead."""

    def __init__(self, num_classes: int = NUM_CLASSES, *,
                 image_size: int = IMAGE_SIZE, patch_size: int = PATCH_SIZE,
                 threshold: float = 50.0, device="cuda", seed: int = 0):
        super().__init__()
        self.vit_cfg = ViTConfig(
            image_size=image_size, image_patch_size=patch_size,
            frames=1, frame_patch_size=1, num_classes=num_classes,
            dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128,
            channels=1, pool="cls")
        # The menu's default threshold (compute_cam reads it).
        self.config = {"GRADCAM_THRESHOLD": threshold}
        self.vit3d = ViT3D(self.vit_cfg, device=device)
        self.vit3d.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def load_jax(self, params: Dict) -> "ViT2D":
        """Take the JAX ViT2D's weights (``variables["params"]``, numpy or
        jax leaves) through ``from_jax_params``; returns self."""
        state = from_jax_params({"volume_encoder": params})
        self.vit3d.load_state_dict(
            {k[len(PREFIX):]: v for k, v in state.items()}, strict=True)
        return self

    @staticmethod
    def _volume(x: torch.Tensor) -> torch.Tensor:
        return x.float()[:, None, None]                 # [B, C=1, F=1, H, W]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W] images -> f32 logits [B, num_classes]."""
        return self.vit3d(self._volume(x))

    def probe(self, x: torch.Tensor, probe_shift: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the probe activation [B, N + 1, dim]); see
        ``ViT3D.probe``."""
        return self.vit3d.probe(self._volume(x), probe_shift)


# --------------------------------------------------------------------------
# Synthetic 2D squares (DatasetGradCAM.py:94-119, one dimension down)
# --------------------------------------------------------------------------

def make_squares(n: int, *, generator: torch.Generator,
                 image_size: int = IMAGE_SIZE, square: int = SQUARE_SIZE,
                 noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """n images of uniform noise below ``noise`` with one square of ones in
    a grid cell; the label is the cell's linear index. Returns (f32
    [n, size, size], int64 [n]) as numpy."""
    cells = image_size // square
    images = noise * torch.rand((n, image_size, image_size),
                                generator=generator)
    labels = torch.randint(0, cells * cells, (n,), generator=generator)
    ys, xs = labels // cells * square, labels % cells * square
    row = torch.arange(image_size)
    mask = ((row[None, :, None] >= ys[:, None, None])
            & (row[None, :, None] < (ys + square)[:, None, None])
            & (row[None, None, :] >= xs[:, None, None])
            & (row[None, None, :] < (xs + square)[:, None, None]))
    images = torch.where(mask, 1.0, images)
    return images.numpy().astype(np.float32), labels.numpy().astype(np.int64)


def train_demo_model(model: ViT2D, *, steps: int = 300, batch: int = 32,
                     seed: int = 0, verbose: bool = True,
                     data: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> torch.Tensor:
    """Train ``model`` in place on the squares task: AdamW at optax.adamw(
    3e-4, weight_decay=0.01)'s settings (the port's ``Optimizer``: betas
    0.9 / 0.999, eps 1e-8, decay on every parameter), softmax cross
    entropy, ``batch`` images a step drawn by ``numpy.random.default_rng(
    seed)`` from ``data`` (default: 2048 squares from ``seed``). Returns
    the step losses [steps] on the model's device."""
    if data is None:
        data = make_squares(2048, generator=torch.Generator().manual_seed(
            seed))
    device = model.device
    images = torch.as_tensor(np.array(data[0], np.float32), device=device)
    labels = torch.as_tensor(np.array(data[1], np.int64), device=device)
    opt = Optimizer({"TRAINING_LEARNING_RATE": DEMO_LR,
                     "TRAINING_WEIGHT_DECAY": DEMO_WEIGHT_DECAY},
                    model.parameters(), steps_per_epoch=steps)
    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(images), batch)).to(device)
        x, y = images[idx], labels[idx]
        logits = model(x)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and (i + 1) % 100 == 0:
            acc = float((logits.argmax(dim=1) == y).float().mean())
            print(f"step {i + 1}/{steps} | loss {float(losses[-1]):.4f} "
                  f"| batch acc {acc:.2f}")
    return torch.stack(losses) if losses else torch.zeros(0, device=device)


# --------------------------------------------------------------------------
# The 2D CAM pipeline (the menu's math over a 2D patch grid)
# --------------------------------------------------------------------------

def finalize_cam_2d(cam: torch.Tensor, size: int,
                    threshold: float) -> torch.Tensor:
    """The CAM tail in 2D: ReLU -> per-sample min-max -> percentile
    threshold -> bilinear upsample to [B, size, size]."""
    return finalize_cam_nd(cam, (size, size), threshold, method="bilinear")


def _scorecam_chunk_2d(model: ViT2D, x1: torch.Tensor,
                       acts_chunk: torch.Tensor) -> torch.Tensor:
    """[K, S] activation channels -> [K, num_classes] logits of x1 masked
    by each channel's min-max normalized bilinear upsample (ScoreCAM)."""
    k, size = acts_chunk.shape[0], model.vit_cfg.image_size
    cs = size // model.vit_cfg.image_patch_size
    masks = F.interpolate(acts_chunk.reshape(k, 1, cs, cs), size=(size, size),
                          mode="bilinear", align_corners=False)[:, 0]
    lo = masks.amin(dim=(1, 2), keepdim=True)
    hi = masks.amax(dim=(1, 2), keepdim=True)
    return model(x1 * ((masks - lo) / (hi - lo + 1e-8)))


# The 2D patch grid: row-major tokens, bilinear masks and tail.
IMAGE = cam_methods.Grid(fold=lambda cam, cs: cam.reshape(-1, cs, cs),
                         scorecam_chunk=_scorecam_chunk_2d,
                         finalize=finalize_cam_2d)


def compute_cam_2d(model: ViT2D, image, method: str = "gradcam",
                   threshold: Optional[float] = None, score_batch: int = 32,
                   aug_smooth: bool = False, eigen_smooth: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """CAM of a [H, W] or [B, H, W] image (numpy or tensor) by any menu
    method but ``gradcam-ref``: (cam [.., H, W] in [0, 1], class_idx [B])
    as numpy. The flags mean what they mean in ``cam_methods.compute_cam``;
    aug_smooth's horizontal flip is axis 2."""
    if method not in METHODS_2D:
        raise ValueError(f"method must be one of {METHODS_2D}, got "
                         f"{method!r}")
    x = torch.as_tensor(np.asarray(image, np.float32)).to(model.device)
    squeeze = x.ndim == 2
    cam, class_idx = cam_methods.grid_cam(
        model, x[None] if squeeze else x, method, IMAGE, threshold,
        score_batch, aug_smooth, eigen_smooth)
    cam = cam.cpu().numpy()
    return (cam[0] if squeeze else cam), class_idx.cpu().numpy()


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------

# matplotlib's ``jet``: its segment table (_cm.py ``_jet_data``), sampled
# into a 256-entry lookup table as ``LinearSegmentedColormap`` does.
_JET = {"red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0),
                (1.0, 0.5)),
        "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
                  (0.91, 0.0), (1.0, 0.0)),
        "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0),
                 (1.0, 0.0))}
_JET_N = 256


def jet(values: np.ndarray) -> np.ndarray:
    """RGB [..., 3] in [0, 1] of values in [0, 1]: ``cm.jet(v)[..., :3]``,
    the value's lookup entry floor(v * 256), 1.0 taking the last."""
    at = np.linspace(0.0, 1.0, _JET_N)
    lut = np.stack([np.interp(at, *zip(*_JET[c]))
                    for c in ("red", "green", "blue")], axis=1)
    idx = np.clip((np.asarray(values, np.float64) * _JET_N).astype(np.int64),
                  0, _JET_N - 1)
    return lut[idx]


def show_cam_on_image(rgb_img: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """Jet overlay with pytorch_grad_cam.utils.image.show_cam_on_image's
    semantics: heatmap = jet(cam); out = (heatmap + img) / max, as uint8.
    rgb_img: [H, W, 3] float in [0, 1]; cam: [H, W] in [0, 1]."""
    overlay = jet(np.clip(cam, 0.0, 1.0)) + np.asarray(rgb_img, np.float64)
    overlay = overlay / max(float(overlay.max()), 1e-8)
    return np.uint8(255 * overlay)


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8 (every row filter 0)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


# --------------------------------------------------------------------------
# CLI (gradcam_original.py:21-35's flags)
# --------------------------------------------------------------------------

def _load_image(path: str, size: int) -> np.ndarray:
    """Image file -> [size, size] grayscale in [0, 1]: the RGB mean, then
    a bilinear resize that antialiases when it shrinks, as
    ``jax.image.resize`` does. Reads the file with ``matplotlib.image``."""
    import matplotlib.image as mpimg
    img = np.asarray(mpimg.imread(path), np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    if img.ndim == 3:
        img = img[..., :3].mean(axis=2)
    return resize_bilinear(img, size)


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W] -> [size, size] f32, bilinear with half-pixel centres,
    antialiased along an axis it shrinks and plain along one it enlarges
    (``jax.image.resize``'s "bilinear"; ``F.interpolate``'s antialias
    widens the triangle filter only where it shrinks)."""
    t = torch.from_numpy(np.asarray(img, np.float32))[None, None]
    return F.interpolate(t, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0].numpy()


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="CAM methods on a 2D ViT (the vendored pytorch_grad_cam "
                    "ViT tutorial, self-contained)")
    parser.add_argument("--image-path", type=str, default=None,
                        help="Input image; default: a synthetic square "
                             "sample like those the demo model trains on")
    parser.add_argument("--method", type=str, default="gradcam",
                        choices=list(METHODS_2D))
    parser.add_argument("--aug_smooth", action="store_true",
                        help="Apply test time augmentation to smooth the CAM")
    parser.add_argument("--eigen_smooth", action="store_true",
                        help="Reduce noise by taking the first principle "
                             "componenet of cam_weights*activations")
    parser.add_argument("--steps", type=int, default=300,
                        help="demo-model training steps")
    parser.add_argument("--threshold", type=float, default=50.0,
                        help="percent of pixels kept by the CAM tail")
    parser.add_argument("--output-dir", type=str, default=".")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the card; 'cpu' runs "
                             "the plain versions of the kernels)")
    args = parser.parse_args(argv)

    model = ViT2D(threshold=args.threshold, device=args.device)
    print(f"Training the demo 2D ViT ({args.steps} steps, "
          f"{NUM_CLASSES}-way square localization)...")
    train_demo_model(model, steps=args.steps)

    if args.image_path is not None:
        image = _load_image(args.image_path, IMAGE_SIZE)
    else:
        image, label = make_squares(
            1, generator=torch.Generator().manual_seed(123))
        image, label = image[0], int(label[0])
        print(f"Synthetic sample: square at cell {label}")

    cam, class_idx = compute_cam_2d(
        model, image, method=args.method, aug_smooth=args.aug_smooth,
        eigen_smooth=args.eigen_smooth)
    print(f"Predicted class: {int(class_idx[0])}")

    rgb = np.repeat(np.clip(image, 0.0, 1.0)[..., None], 3, axis=2)
    overlay = show_cam_on_image(rgb, cam)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.method}_cam.png")
    write_png(out_path, overlay)
    print(f"Saved {out_path}")
    return out_path


if __name__ == "__main__":
    main()
