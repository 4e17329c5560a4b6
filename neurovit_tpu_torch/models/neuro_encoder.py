"""NeuroEncoder, 3D and 4D (the ViT or the ResNet volume encoder), for
serving and training.

Counterpart of ``neurovit_tpu/models/neuro_encoder.py``:

- ``num_classes``: (grid / cube)^3 for the synthetic ``gradcam`` dataset,
  else 2 (neuro_encoder.py:50-51);
- the compute dtype comes from ``TRAINING_PRECISION`` (bf16 or f32,
  neuro_encoder.py:120-121); parameters stay f32;
- the input transpose [B, H, W, D] -> [B, 1, D, H, W] (neuro_encoder.py:150);
- ``MODEL_VOLUME_ENCODER`` picks the encoder (neuro_encoder.py:53,128-155):
  ``vit`` (the default) or ``resnet``, the 3D ResNet of
  ``MODEL_RESNET_DEPTH`` (default 18) with one input channel;
- ViT: ``dropout`` and ``emb_dropout`` from ``TRAINING_DROPOUT``
  (neuro_encoder.py:63,99-100), applied when ``forward(train=True)``;
  ``SERVING_INT8_ATTN`` picks the attention of int8 serving
  (neuro_encoder.py:74-84): "pv" (the default, and YAML ``on``) or "off".
  The JAX package's environment default ``NEUROVIT_INT8_ATTN`` is not read:
  the port has no environment switches;
  ``TRAINING_REMAT`` recomputes blocks 0..depth-2 in the backward
  (``ViTConfig.remat``, neuro_encoder.py:102); the 4D model's frozen
  encoder records no graph, so it has nothing to recompute there;
- ResNet: ``forward(train=True)`` normalizes by the batch statistics and
  moves the BatchNorm running stats (the JAX model's ``state``), which
  ``train=False`` uses; the ResNet has no dropout and ignores
  ``TRAINING_REMAT``, as JAX does;
- everything is trainable in 3D (``trainable_mask``, ``param_count``,
  neuro_encoder.py:240-258);
- 4D (``TRAINING_DIM: 4``, neuro_encoder.py:156-238): ``forward`` takes
  [B, H, W, D, T] sequences. ``encode_sequence`` folds T into the batch
  and runs the volume encoder frozen (``requires_grad_(False)``), in eval
  and under ``torch.no_grad()`` on all B·T volumes in one call, giving f32
  encodings [B, T, num_classes]; ``apply_features`` casts them to the
  compute dtype, runs ``models.temporal``'s layer (dropout
  ``MODEL_TEMPORAL_DROPOUT``, default 0.1, when ``train``), takes the mean
  over T in f32 and applies the projection, giving f32 logits. The frozen
  encoder is not trainable (``trainable_mask``). ``encoder`` stands in for
  the ViT in ``encode_sequence`` (the trainer's int8 copy,
  ``TRAINING_4D_ENCODER_QUANT``);
- Grad-CAM of the ViT (neuro_encoder.py:143-179, 262-268): ``probe`` is
  ``apply`` with a ``probe_shift``, returning the logits and the last
  block's attention-LN activation; ``get_attention_map`` and
  ``visualize_slice`` are ``explainability.gradcam_vit3d``'s. The model
  holds its weights, so they take no ``variables``. The ResNet's CAMs are
  ``explainability.gradcam_resnet``'s.

The module paths ``volume_encoder.vit3d`` and ``resnet_3d.resnet`` are the
reference's, so the state-dict keys are the checkpoint keys (the ResNet's
BatchNorm running stats among them). ``KERNEL_IMPL`` is not read: on a
CUDA device the blocks always run the kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn as tnn

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.resnet3d import ResNet3D, ResNetConfig
from neurovit_tpu_torch.models.temporal import (ProjectionHead,
                                                TemporalConfig,
                                                TemporalTransformer)
from neurovit_tpu_torch.models.vit3d import ViT3D, ViTConfig
from neurovit_tpu_torch.parallel import sharding
from neurovit_tpu_torch.parallel.mesh import current_mesh


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


class ResNet3DEncoder(tnn.Module):
    """Holds the ResNet under the reference's attribute name (``resnet``)."""

    def __init__(self, cfg: ResNetConfig, *, device=None):
        super().__init__()
        self.resnet = ResNet3D(cfg, device=device)


class NeuroEncoder(tnn.Module):
    """[B, H, W, D] volumes (3D) or [B, H, W, D, T] sequences (4D) -> f32
    logits [B, num_classes].

    Parameters are drawn from ``torch.Generator().manual_seed(seed)``
    (default ``TRAINING_SEED``) on the CPU and copied to ``device``, so a
    seed gives the same weights on every device."""

    def __init__(self, config: Dict[str, Any], *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        self.config = config
        self.is_4d = int(config.get("TRAINING_DIM", 3)) == 4
        self.encoder_kind = config.get("MODEL_VOLUME_ENCODER", "vit")
        if self.encoder_kind not in ("vit", "resnet"):
            raise ValueError(f"unknown MODEL_VOLUME_ENCODER "
                             f"{self.encoder_kind!r} (supported: 'vit', "
                             "'resnet')")
        if int(config.get("MESH_PIPE_AXIS", 1)) > 1:
            raise not_ported("pipeline parallelism (MESH_PIPE_AXIS > 1)",
                              "multi-GPU")
        if self.encoder_kind == "vit":
            if config.get("MODEL_VIT_PATCH_EMBED", "auto") == "conv":
                raise not_ported("the conv patch embed", "odds and ends")
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
            int8_attn=int8_attn_mode(config.get("SERVING_INT8_ATTN")),
            remat=bool(config.get("TRAINING_REMAT", False)))
        self.resnet_cfg = ResNetConfig(
            depth=int(config.get("MODEL_RESNET_DEPTH", 18)),
            n_input_channels=1, n_classes=self.num_classes)
        precision = config.get("TRAINING_PRECISION", "bf16")
        self.compute_dtype = (torch.bfloat16 if precision == "bf16"
                              else torch.float32)
        gen = torch.Generator().manual_seed(
            int(seed if seed is not None else config.get("TRAINING_SEED", 42)))
        if self.encoder_kind == "resnet":
            self.resnet_3d = ResNet3DEncoder(self.resnet_cfg, device=device)
            self.resnet_3d.resnet.reset_parameters(gen)
        else:
            self.volume_encoder = ViT3DEncoder(self.vit_cfg, device=device)
            self.volume_encoder.vit3d.reset_parameters(gen)
        if self.is_4d:
            # The reference leaves torch's default 0.1 on the temporal layer
            # whatever TRAINING_DROPOUT says (neuro_encoder.py:113-119).
            self.temporal_cfg = TemporalConfig(
                d_model=self.num_classes, nhead=2, num_layers=1,
                dropout=float(config.get("MODEL_TEMPORAL_DROPOUT", 0.1)))
            self.temporal_transformer = TemporalTransformer(
                self.temporal_cfg, device=device)
            self.temporal_transformer.reset_parameters(gen)
            self.projection_head = ProjectionHead(
                self.num_classes, self.num_classes, device=device)
            self.projection_head.reset_parameters(gen)
            self.frozen_encoder.requires_grad_(False)

    @property
    def frozen_encoder(self) -> tnn.Module:
        """The volume encoder's module (``volume_encoder`` or
        ``resnet_3d``), frozen in 4D."""
        return (self.resnet_3d if self.encoder_kind == "resnet"
                else self.volume_encoder)

    @property
    def device(self) -> torch.device:
        """The device of the parameters."""
        return next(self.parameters()).device

    def encode_volume(self, volumes: torch.Tensor, *, train: bool = False,
                      seed: Optional[int] = None,
                      encoder: Optional[ViT3D] = None) -> torch.Tensor:
        """[B, H, W, D] -> f32 logits [B, num_classes] of the volume
        encoder (neuro_encoder.py:143-154); ``encoder`` replaces the ViT."""
        x = volumes.permute(0, 3, 1, 2)[:, None]      # [B, 1, D, H, W]
        if self.encoder_kind == "resnet":
            return self.resnet_3d.resnet(x.to(self.compute_dtype),
                                         train=train)
        vit = encoder if encoder is not None else self.volume_encoder.vit3d
        return vit(x.to(self.compute_dtype), train=train, seed=seed)

    def forward(self, volumes: torch.Tensor, *, train: bool = False,
                seed: Optional[int] = None,
                encoder: Optional[ViT3D] = None) -> torch.Tensor:
        """3D: [B, H, W, D] volumes; ``train=True`` applies the ViT's
        dropout keyed by the step's ``seed``, or the ResNet's batch
        statistics. 4D: [B, H, W, D, T] sequences through the frozen
        encoder (``encoder`` in place of the ViT), then the temporal head,
        its dropout keyed by ``seed`` when ``train``."""
        if not self.is_4d:
            return self.encode_volume(volumes, train=train, seed=seed,
                                      encoder=encoder)
        return self.apply_features(
            self.encode_sequence(volumes, encoder=encoder), train=train,
            seed=seed)

    def encode_sequence(self, x: torch.Tensor, *,
                        encoder: Optional[ViT3D] = None) -> torch.Tensor:
        """[B, H, W, D, T] -> f32 encodings [B, T, num_classes]: every
        timepoint through the frozen volume encoder in eval, all B·T
        volumes in one call, recording no autograd graph
        (neuro_encoder.py:188-218). Deterministic, so a static 4D dataset's
        encodings are the same every epoch (the feature cache's premise).

        Inside a data-parallel ``parallel.use_mesh`` whose data axis
        divides B·T, data index d encodes its contiguous 1/data of the
        folded stream and the data group's encodings are gathered in order
        (neuro_encoder.py:200-206); otherwise the stream stays whole. On a
        model axis above 1 the encoder is this process's shard and runs
        tensor-parallel over the model group (``models.vit3d``)."""
        b, h, w, d, t = x.shape
        vols = x.to(self.compute_dtype).permute(0, 4, 1, 2, 3).reshape(
            b * t, h, w, d)
        mesh = current_mesh()
        split = mesh is not None and (b * t) % mesh.data == 0
        if split:                # this rank's contiguous part of the stream
            part = b * t // mesh.data
            vols = vols[mesh.rank * part:(mesh.rank + 1) * part]
        with torch.no_grad():
            enc = self.encode_volume(vols, encoder=encoder).float()
            if split:
                enc = sharding.gather_stream(enc, mesh)
        return enc.reshape(b, t, self.num_classes)

    def apply_features(self, enc: torch.Tensor, *, train: bool = False,
                       seed: Optional[int] = None) -> torch.Tensor:
        """Encodings [B, T, num_classes] (fresh or cached) -> f32 logits
        [B, num_classes]: the temporal layer in the compute dtype, the mean
        over T summed in f32 (``jnp.mean`` of bf16), the projection
        (neuro_encoder.py:220-238); in f32 its products at full f32
        (``nn.full_f32``)."""
        rate = self.temporal_cfg.dropout if train else 0.0
        if rate and seed is None:
            raise ValueError("dropout in training needs a seed")
        with nn.full_f32(self.compute_dtype):
            x = self.temporal_transformer(enc.to(self.compute_dtype), rate,
                                          seed if rate else 0)
            pooled = x.float().mean(dim=1).to(x.dtype)
            return self.projection_head(pooled).float()

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trainable: everything in 3D; in 4D all but
        the frozen volume encoder (neuro_encoder.py:240-249)."""
        frozen = ("resnet_3d." if self.encoder_kind == "resnet"
                  else "volume_encoder.")
        return {name: not (self.is_4d and name.startswith(frozen))
                for name, _ in self.named_parameters()}

    def param_count(self) -> Tuple[int, int]:
        """(total, trainable) parameter counts (the trainer's banner)."""
        mask = self.trainable_mask()
        sizes = {name: p.numel() for name, p in self.named_parameters()}
        return (sum(sizes.values()),
                sum(s for name, s in sizes.items() if mask[name]))

    def probe(self, volumes: torch.Tensor, probe_shift: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, D] volumes and a shift [B, N + 1, dim] -> (f32 logits,
        the probe activation in the compute dtype); see ``ViT3D.probe``.
        The ViT's only: the ResNet's probe is ``gradcam_resnet``'s."""
        if self.encoder_kind != "vit":
            raise ValueError("the attention probe is the ViT's; the ResNet's "
                             "CAMs are explainability.gradcam_resnet's")
        if self.is_4d:
            raise ValueError("the attention probe takes 3D volumes")
        x = volumes.permute(0, 3, 1, 2)[:, None]      # [B, 1, D, H, W]
        return self.volume_encoder.vit3d.probe(x.to(self.compute_dtype),
                                               probe_shift)

    def get_attention_map(self, x, threshold: Optional[float] = None):
        """(cam_3d, class_idx) of [B, H, W, D] or [H, W, D] volumes, as the
        reference's ``NeuroEncoder.get_attention_map``."""
        from neurovit_tpu_torch.explainability.gradcam_vit3d import \
            get_attention_map
        return get_attention_map(self, x, threshold=threshold)

    def visualize_slice(self, cam_3d, original_volume):
        from neurovit_tpu_torch.explainability.gradcam_vit3d import \
            visualize_slice
        return visualize_slice(self.config, cam_3d, original_volume)
