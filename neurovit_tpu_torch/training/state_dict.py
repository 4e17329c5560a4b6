"""Weights between the JAX package and the port, under the reference's
torch key names.

The port's module attributes follow the keys of
``neurovit_tpu/training/state_dict.py:35-77`` (e.g.
``volume_encoder.vit3d.transformer.layers.{i}.0.to_qkv.weight``), so a
checkpoint the JAX package wrote with ``state_dict.save`` (torch's zip
format) loads with ``model.load_state_dict(load(path))``, and
:func:`save` writes torch's zip format, which the JAX package's
``state_dict.load`` reads (``neurovit_tpu/training/state_dict.py:338-349``):
weights trained by the port load in JAX. :func:`from_jax_params` converts a
JAX params pytree in memory, which is how the tests give both packages the
same weights.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

PREFIX = "volume_encoder.vit3d."

# (torch key suffix, path in the JAX ViT params, transpose). JAX kernels are
# [in, out]; torch Linear weights are [out, in].
_TOP: List[Tuple[str, Tuple[str, ...], bool]] = [
    ("to_patch_embedding.1.weight", ("patch_embed", "norm_pre", "scale"), False),
    ("to_patch_embedding.1.bias", ("patch_embed", "norm_pre", "bias"), False),
    ("to_patch_embedding.2.weight", ("patch_embed", "proj", "kernel"), True),
    ("to_patch_embedding.2.bias", ("patch_embed", "proj", "bias"), False),
    ("to_patch_embedding.3.weight", ("patch_embed", "norm_post", "scale"), False),
    ("to_patch_embedding.3.bias", ("patch_embed", "norm_post", "bias"), False),
    ("pos_embedding", ("pos_embedding",), False),
    ("cls_token", ("cls_token",), False),
    ("mlp_head.0.weight", ("head", "norm", "scale"), False),
    ("mlp_head.0.bias", ("head", "norm", "bias"), False),
    ("mlp_head.1.weight", ("head", "fc", "kernel"), True),
    ("mlp_head.1.bias", ("head", "fc", "bias"), False),
]
# Per block, under transformer.layers.{i}.; JAX stacks blocks on axis 0.
_BLOCK: List[Tuple[str, Tuple[str, ...], bool]] = [
    ("0.norm.weight", ("attn_norm", "scale"), False),
    ("0.norm.bias", ("attn_norm", "bias"), False),
    ("0.to_qkv.weight", ("qkv", "kernel"), True),
    ("0.to_out.0.weight", ("attn_out", "kernel"), True),
    ("0.to_out.0.bias", ("attn_out", "bias"), False),
    ("1.net.0.weight", ("mlp_norm", "scale"), False),
    ("1.net.0.bias", ("mlp_norm", "bias"), False),
    ("1.net.1.weight", ("fc1", "kernel"), True),
    ("1.net.1.bias", ("fc1", "bias"), False),
    ("1.net.4.weight", ("fc2", "kernel"), True),
    ("1.net.4.bias", ("fc2", "bias"), False),
]


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, transpose: bool) -> torch.Tensor:
    return torch.from_numpy(np.array(arr.T if transpose else arr))


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NeuroEncoder params (``{"volume_encoder": ViT params}``, numpy
    leaves) -> the port's state dict: the stacked depth axis unstacked, the
    [in, out] kernels transposed to torch's [out, in]."""
    vit = params["volume_encoder"]
    blocks = vit["blocks"]
    depth = np.asarray(blocks["qkv"]["kernel"]).shape[0]
    out = {PREFIX + key: _tensor(_get(vit, path), t) for key, path, t in _TOP}
    for i in range(depth):
        for key, path, t in _BLOCK:
            out[f"{PREFIX}transformer.layers.{i}.{key}"] = _tensor(
                _get(blocks, path)[i], t)
    return out


def save(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a flat state dict with ``torch.save``: each tensor detached,
    on the CPU and in its own contiguous storage (no views shared between
    entries), under the reference's key names."""
    torch.save({k: v.detach().cpu().contiguous().clone()
                for k, v in state_dict.items()}, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch-format state dict (what the JAX package's
    ``state_dict.save`` and ``torch.save`` write) onto the CPU. Only
    tensors and plain containers unpickle (``weights_only``): a checkpoint
    is untrusted input."""
    return torch.load(path, map_location="cpu", weights_only=True)
