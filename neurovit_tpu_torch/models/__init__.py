"""The 3D ViT and the top-level NeuroEncoder (3D mode)."""

from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder  # noqa: F401
from neurovit_tpu_torch.models.vit3d import ViTConfig  # noqa: F401
