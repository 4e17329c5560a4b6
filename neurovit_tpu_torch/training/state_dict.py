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
same weights. It takes the ViT's params pytree or the ResNet's
``{"params", "state"}``: the ResNet's OIDHW convs go across as they are,
its Linear head is transposed, and its BatchNorm running stats fill the
``nn.BatchNorm3d`` buffers (the keys of
``neurovit_tpu/training/state_dict.py:107-157``), with a
``num_batches_tracked`` of 0 as JAX's ``to_state_dict`` writes it. A 4D
model's ``temporal`` and ``projection`` subtrees go across with either
encoder, under ``temporal_transformer.`` and ``projection_head.``
(state_dict.py:80-104).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

PREFIX = "volume_encoder.vit3d."
RESNET_PREFIX = "resnet_3d.resnet."

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


# The 4D head (state_dict.py:80-104): the temporal layer under
# temporal_transformer.transformer.layers.0. and the projection.
_TEMPORAL_LAYER = "temporal_transformer.transformer.layers.0."
_TEMPORAL: List[Tuple[str, Tuple[str, ...], bool]] = [
    (_TEMPORAL_LAYER + "self_attn.in_proj_weight",
     ("temporal", "layer0", "in_proj", "kernel"), True),
    (_TEMPORAL_LAYER + "self_attn.in_proj_bias",
     ("temporal", "layer0", "in_proj", "bias"), False),
    (_TEMPORAL_LAYER + "self_attn.out_proj.weight",
     ("temporal", "layer0", "out_proj", "kernel"), True),
    (_TEMPORAL_LAYER + "self_attn.out_proj.bias",
     ("temporal", "layer0", "out_proj", "bias"), False),
    (_TEMPORAL_LAYER + "linear1.weight",
     ("temporal", "layer0", "fc1", "kernel"), True),
    (_TEMPORAL_LAYER + "linear1.bias",
     ("temporal", "layer0", "fc1", "bias"), False),
    (_TEMPORAL_LAYER + "linear2.weight",
     ("temporal", "layer0", "fc2", "kernel"), True),
    (_TEMPORAL_LAYER + "linear2.bias",
     ("temporal", "layer0", "fc2", "bias"), False),
    (_TEMPORAL_LAYER + "norm1.weight",
     ("temporal", "layer0", "norm1", "scale"), False),
    (_TEMPORAL_LAYER + "norm1.bias",
     ("temporal", "layer0", "norm1", "bias"), False),
    (_TEMPORAL_LAYER + "norm2.weight",
     ("temporal", "layer0", "norm2", "scale"), False),
    (_TEMPORAL_LAYER + "norm2.bias",
     ("temporal", "layer0", "norm2", "bias"), False),
    ("projection_head.projection_head.weight", ("projection", "kernel"),
     True),
    ("projection_head.projection_head.bias", ("projection", "bias"), False),
]


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, transpose: bool) -> torch.Tensor:
    return torch.from_numpy(np.array(arr.T if transpose else arr))


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NeuroEncoder weights (numpy leaves) -> the port's state dict.
    The ViT's params (``{"volume_encoder": ViT params}``): the stacked depth
    axis unstacked, the [in, out] kernels transposed to torch's [out, in].
    The ResNet's variables (``{"params": {"volume_encoder": ...}, "state":
    {"volume_encoder": ...}}``): see :func:`_resnet_state_dict`."""
    if "params" in params:
        out = _resnet_state_dict(params["params"]["volume_encoder"],
                                 params["state"]["volume_encoder"])
        return {**out, **_temporal_state_dict(params["params"])}
    vit = params["volume_encoder"]
    blocks = vit["blocks"]
    depth = np.asarray(blocks["qkv"]["kernel"]).shape[0]
    out = {PREFIX + key: _tensor(_get(vit, path), t) for key, path, t in _TOP}
    for i in range(depth):
        for key, path, t in _BLOCK:
            out[f"{PREFIX}transformer.layers.{i}.{key}"] = _tensor(
                _get(blocks, path)[i], t)
    return {**out, **_temporal_state_dict(params)}


def _temporal_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The 4D head's entries when ``params`` has its ``temporal`` and
    ``projection`` subtrees (a 4D model), else none; kernels transposed."""
    if "temporal" not in params:
        return {}
    return {key: _tensor(_get(params, path), t) for key, path, t in _TEMPORAL}


def _bn(key: str, params: Dict[str, Any], state: Dict[str, Any]
        ) -> Dict[str, torch.Tensor]:
    """A BatchNorm3d's entries: affine from params, running stats from the
    state, and torch's step counter (state_dict.py:107-116, 228-232)."""
    return {f"{key}.weight": _tensor(np.asarray(params["scale"]), False),
            f"{key}.bias": _tensor(np.asarray(params["bias"]), False),
            f"{key}.running_mean": _tensor(np.asarray(state["mean"]), False),
            f"{key}.running_var": _tensor(np.asarray(state["var"]), False),
            f"{key}.num_batches_tracked": torch.tensor(0, dtype=torch.int64)}


def _resnet_state_dict(params: Dict[str, Any], state: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """The JAX ResNet's params and BN state -> ``resnet_3d.resnet.*`` keys
    (state_dict.py:119-157): conv1/bn1, layer{1..4}.{b} blocks with
    conv{c}/bn{c} and shortcut B's downsample.{0,1}, and fc."""
    p = RESNET_PREFIX
    out = {f"{p}conv1.weight": _tensor(np.asarray(params["conv1"]["kernel"]),
                                       False)}
    out.update(_bn(f"{p}bn1", params["bn1"], state["bn1"]))
    for s in range(1, 5):
        for b, (bp, bs) in enumerate(zip(params[f"layer{s}"],
                                         state[f"layer{s}"])):
            tp = f"{p}layer{s}.{b}."
            for c in (1, 2, 3):
                if f"conv{c}" in bp:
                    out[f"{tp}conv{c}.weight"] = _tensor(
                        np.asarray(bp[f"conv{c}"]["kernel"]), False)
                    out.update(_bn(f"{tp}bn{c}", bp[f"bn{c}"], bs[f"bn{c}"]))
            if "ds_conv" in bp:
                out[f"{tp}downsample.0.weight"] = _tensor(
                    np.asarray(bp["ds_conv"]["kernel"]), False)
                out.update(_bn(f"{tp}downsample.1", bp["ds_bn"],
                               bs["ds_bn"]))
    out[f"{p}fc.weight"] = _tensor(np.asarray(params["fc"]["kernel"]), True)
    out[f"{p}fc.bias"] = _tensor(np.asarray(params["fc"]["bias"]), False)
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
