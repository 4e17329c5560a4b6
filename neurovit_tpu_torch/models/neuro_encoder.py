"""NeuroEncoder, 3D ViT mode, for serving and training.

Counterpart of ``neurovit_tpu/models/neuro_encoder.py`` for ``TRAINING_DIM:
3`` with the ViT volume encoder:

- ``num_classes``: (grid / cube)^3 for the synthetic ``gradcam`` dataset,
  else 2 (neuro_encoder.py:50-51);
- the compute dtype comes from ``TRAINING_PRECISION`` (bf16 or f32,
  neuro_encoder.py:120-121); parameters stay f32;
- the input transpose [B, H, W, D] -> [B, 1, D, H, W] (neuro_encoder.py:150);
- ``dropout`` and ``emb_dropout`` from ``TRAINING_DROPOUT``
  (neuro_encoder.py:63,99-100), applied when ``forward(train=True)``;
- everything is trainable in 3D (``trainable_mask``, ``param_count``,
  neuro_encoder.py:240-258);
- ``SERVING_INT8_ATTN`` picks the attention of int8 serving
  (neuro_encoder.py:74-84): "pv" (the default, and YAML ``on``) or "off".
  The JAX package's environment default ``NEUROVIT_INT8_ATTN`` is not read:
  the port has no environment switches.

The module path ``volume_encoder.vit3d`` is the reference's, so the
state-dict keys are the checkpoint keys. ``KERNEL_IMPL`` is not read: on a
CUDA device the blocks always run the kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from neurovit_tpu_torch.models.vit3d import ViT3D, ViTConfig


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to neurovit_tpu_torch yet "
        f"(ROADMAP.md, Queue 1: {item})")


def int8_attn_mode(raw) -> str:
    """``SERVING_INT8_ATTN`` as the model's ``int8_attn``: unset gives
    "pv"; YAML parses bare on/off as booleans (True "pv", False "off");
    other values are "pv" or "off" in any case, else ValueError."""
    if raw is None:
        return "pv"
    if isinstance(raw, bool):
        return "pv" if raw else "off"
    mode = str(raw).lower()
    if mode not in ("pv", "off"):
        raise ValueError(f"unknown SERVING_INT8_ATTN {mode!r} "
                         "(supported: 'pv', 'off')")
    return mode


class ViT3DEncoder(tnn.Module):
    """Holds the ViT under the reference's attribute name (``vit3d``)."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        self.vit3d = ViT3D(cfg, device=device)


class NeuroEncoder(tnn.Module):
    """[B, H, W, D] volumes -> f32 logits [B, num_classes].

    Parameters are drawn from ``torch.Generator().manual_seed(seed)``
    (default ``TRAINING_SEED``) on the CPU and copied to ``device``, so a
    seed gives the same weights on every device."""

    def __init__(self, config: Dict[str, Any], *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        self.config = config
        if int(config.get("TRAINING_DIM", 3)) == 4:
            raise not_ported("4D mode (TRAINING_DIM: 4)", "4D")
        if config.get("MODEL_VOLUME_ENCODER", "vit") != "vit":
            raise not_ported("the 3D ResNet encoder", "ResNet")
        if int(config.get("MESH_PIPE_AXIS", 1)) > 1:
            raise not_ported("pipeline parallelism (MESH_PIPE_AXIS > 1)",
                              "multi-GPU")
        if config.get("MODEL_VIT_PATCH_EMBED", "auto") == "conv":
            raise not_ported("the conv patch embed", "odds and ends")
        if bool(config.get("TRAINING_REMAT", False)):
            raise not_ported("remat (TRAINING_REMAT)", "train step, remat")
        grid = config["TRAINING_VIT_INPUT_SIZE"]
        patch = config["TRAINING_VIT_PATCH_SIZE"]
        cube = config.get("GRADCAM_CUBE_SIZE", 8)
        self.num_classes = ((grid // cube) ** 3
                            if config["DATASET_NAME"] == "gradcam" else 2)
        self.vit_cfg = ViTConfig(
            image_size=grid, image_patch_size=patch, frames=grid,
            frame_patch_size=patch, num_classes=self.num_classes,
            dim=config.get("MODEL_VIT_DIM", 1024),
            depth=config.get("MODEL_VIT_DEPTH", 6),
            heads=config.get("MODEL_VIT_HEADS", 8),
            dim_head=config.get("MODEL_VIT_DIM_HEAD", 64),
            mlp_dim=config.get("MODEL_VIT_MLP_DIM", 2048),
            channels=1, pool=config.get("MODEL_VIT_POOL", "cls"),
            dropout=float(config.get("TRAINING_DROPOUT", 0.0)),
            emb_dropout=float(config.get("TRAINING_DROPOUT", 0.0)),
            int8_attn=int8_attn_mode(config.get("SERVING_INT8_ATTN")))
        precision = config.get("TRAINING_PRECISION", "bf16")
        self.compute_dtype = (torch.bfloat16 if precision == "bf16"
                              else torch.float32)
        self.volume_encoder = ViT3DEncoder(self.vit_cfg, device=device)
        gen = torch.Generator().manual_seed(
            int(seed if seed is not None else config.get("TRAINING_SEED", 42)))
        self.volume_encoder.vit3d.reset_parameters(gen)

    def forward(self, volumes: torch.Tensor, *, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        """``train=True`` applies dropout keyed by the step's ``seed``."""
        x = volumes.permute(0, 3, 1, 2)[:, None]      # [B, 1, D, H, W]
        return self.volume_encoder.vit3d(x.to(self.compute_dtype),
                                         train=train, seed=seed)

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trainable. In 3D every parameter is
        (neuro_encoder.py:240-249: only the 4D frozen encoder is not)."""
        return {name: True for name, _ in self.named_parameters()}

    def param_count(self) -> Tuple[int, int]:
        """(total, trainable) parameter counts (the trainer's banner)."""
        mask = self.trainable_mask()
        sizes = {name: p.numel() for name, p in self.named_parameters()}
        return (sum(sizes.values()),
                sum(s for name, s in sizes.items() if mask[name]))

    def get_attention_map(self, *args, **kwargs):
        raise not_ported("Grad-CAM (the attention-LN probe)", "Grad-CAM")
