"""Megatron-style tensor parallelism of the ViT blocks over the model axis.

Counterpart of the tensor-parallel half of ``neurovit_tpu/parallel/
sharding.py`` (``_TP_RULES`` :69-91, ``param_shardings`` :112-126,
``place_opt_state`` :129-173). XLA's partitioner inserts JAX's collectives
from the shardings; here the shards and the collectives are written out.

**The rules** (:func:`rule`). A shard of a block holds, for model index m
of ``tp``:

- column-parallel: Wqkv's rows of the heads ``[m H / tp, (m + 1) H /
  tp)`` of each of q, k and v (``to_qkv.weight``; int8: ``qkv_w8`` and
  ``qkv_scale``), and fc1's rows ``[m hid / tp, (m + 1) hid / tp)`` with
  its bias (int8: ``fc1_w8``, ``fc1_scale``, ``fc1_bias``);
- row-parallel: the same heads' columns of Wout (``to_out.0.weight``;
  ``out_w8``) and the same hidden columns of W2 (``net.4.weight``;
  ``fc2_w8``). Their biases and per-output-column int8 scales stay whole;
- whole: the LayerNorm affines, the embedding, ``cls``, ``pos_embedding``
  and the head.

**The departure from** ``_TP_RULES``: JAX splits Wqkv's fused ``3 inner``
output dimension contiguously (``("qkv", "kernel"): "col"``), so a shard
holds all of q and part of k, or part of k and all of v, and XLA reshards
the product before the attention. The port splits q, k and v each by
heads, so the attention kernels (K1, K5, K13) run on the shard's own heads
with no collective, and the shard is a ViT of ``H / tp`` heads and
``mlp_dim / tp`` hidden columns (:func:`shard_config`). A ``heads`` or an
``mlp_dim`` the model axis does not divide is refused (ROADMAP.md,
Queue 3). int8 follows ``_TP_RULES``' ``*_q8`` entries: the whole block is
quantized first (``models.vit3d.quantize_blocks``), then cut, because a
row-parallel shard quantized alone would take each column's amax over its
own K only. AdamW's moments take their parameter's shard, as
``place_opt_state`` places them (:func:`cut_optimizer_state`).

**The collectives** are Megatron's f and g (Shoeybi et al., 2019). g sums
a row-parallel product's partials over the model group in the forward and
passes the gradient through; f passes the input through and sums a
column-parallel region's input gradient in the backward. The partials are
f32 (``ops/tp_forms.py``): the model group sums them in f32 and the sum is
rounded to x's dtype once, as the one-process kernels round once. An edge
between two ``autograd.Function``s carries its gradient in the tensor's
own dtype, so a bf16 partial would be rounded there; f and g therefore sit
inside the Functions at the regions' ends: g in :class:`_OutprojShard` and
:class:`_MlpShard`'s forwards, f in :class:`_LnQkvShard` and
:class:`_MlpShard`'s backwards. The attention's residual is not summed: its
gradient, dy, is the out-projection's input gradient on every rank, and
its bias's gradient is rank 0's (the trainer sums it over the model group,
:func:`partial_names`). The MLP's residual is in rank 0's partial, ``[m = 0] x
+ Drop(a_m W_m^T + [m = 0] b)``, inside the one Function, so its gradient
enters rank 0's f32 partial dx and the model group's sum once. The int8
blocks' partials are the int32 accumulators of their last GEMMs, summed
exactly; the dequantization, the bias and the residual run once on the
sum, so an int8 replica's output is one card's bit for bit.

**The dropout keys.** Row-parallel sites (the out-projection's and the MLP
output's) are whole tensors: the model group draws one mask, the
one-process key. Column-parallel sites (the attention probabilities of the
shard's heads, the MLP hidden of its columns) would repeat a mask across
the shards under one key, so the model index is folded into their keys
(:func:`column_seed`, ``nn.site_seed``): the kernels take no head or column
offset, and a fold changes no kernel.

**Where they run.** A training mesh's process holds one shard, and
:class:`ProcessComm` runs the collectives over the mesh's model group (gloo
on the CPU, NCCL on the card). A serving replica within one process holds
its shards on its cards (:class:`TensorParallelViT`), and
:class:`LocalComm` sums the shards' tensors on its first card. Both run the
blocks through :func:`tp_block`, over a list of the shards this process
holds (one in a process group).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn as tnn

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.models.vit3d import (Int8Attention, ViT3D,
                                             ViTConfig, quantize_blocks)
from neurovit_tpu_torch.ops import tp_forms
from neurovit_tpu_torch.ops.common import SHAPE_QUEUE, is_training, pick
from neurovit_tpu_torch.ops.common import weight_grad
from neurovit_tpu_torch.ops.flash_attention import flash_attention
from neurovit_tpu_torch.ops.fused_outproj import (fused_outproj_bwd_cuda,
                                                  fused_outproj_bwd_f32_cuda,
                                                  fused_outproj_bwd_plain)
from neurovit_tpu_torch.ops.fused_qkv import (fused_ln_qkv,
                                              fused_ln_qkv_cuda,
                                              fused_ln_qkv_f32_cuda,
                                              fused_ln_qkv_plain)
from neurovit_tpu_torch.ops.int8_serving import (int8_flash_attention,
                                                 int8_ln_qkv)

_BLOCK = r"(?:^|\.)transformer\.layers\.\d+\."
# Key suffix within a block -> rule: "heads" cuts q, k and v by heads along
# dim 0 ([3 inner, ...] or [3 inner]); "col" dim 0; "row" dim 1.
_RULES = {
    "0.to_qkv.weight": "heads", "0.qkv_w8": "heads", "0.qkv_scale": "heads",
    "1.net.1.weight": "col", "1.net.1.bias": "col", "1.fc1_w8": "col",
    "1.fc1_scale": "col", "1.fc1_bias": "col",
    "0.to_out.0.weight": "row", "0.out_w8": "row",
    "1.net.4.weight": "row", "1.fc2_w8": "row",
}
_RULE_RE = re.compile(_BLOCK + "(" + "|".join(
    re.escape(k) for k in _RULES) + ")$")
# The parameters whose gradient each model rank holds in part: the
# LayerNorm affines (their shard's share of du) and the row-parallel biases
# (rank 0's partial adds them).
_PARTIAL_RE = re.compile(_BLOCK + r"(?:0\.norm\.(?:weight|bias)|"
                         r"0\.to_out\.0\.bias|1\.net\.0\.(?:weight|bias)|"
                         r"1\.net\.4\.bias)$")


def rule(key: str) -> Optional[str]:
    """The tensor-parallel rule of a state-dict key: "heads", "col",
    "row", or None (whole)."""
    m = _RULE_RE.search(key)
    return _RULES[m.group(1)] if m else None


def partial_names(names) -> List[str]:
    """The parameters among ``names`` whose gradients the model group
    sums."""
    return [n for n in names if _PARTIAL_RE.search(n)]


def check_divisible(cfg: ViTConfig, tp: int) -> None:
    """Raise unless the model axis divides the heads and the MLP width."""
    for name, width in (("heads", cfg.heads), ("mlp_dim", cfg.mlp_dim)):
        if width % tp:
            raise ValueError(
                f"tensor parallelism cuts the ViT's {name} by the model "
                f"axis: MESH_MODEL_AXIS={tp} does not divide {name} "
                f"{width} ({SHAPE_QUEUE})")


def shard_config(cfg: ViTConfig, tp: int) -> ViTConfig:
    """A shard's ViT: ``heads / tp`` heads and ``mlp_dim / tp`` hidden
    columns, every other width whole."""
    import dataclasses
    check_divisible(cfg, tp)
    return dataclasses.replace(cfg, heads=cfg.heads // tp,
                               mlp_dim=cfg.mlp_dim // tp)


def cut(t: torch.Tensor, how: Optional[str], m: int, tp: int
        ) -> torch.Tensor:
    """Shard m of tp of a whole tensor under rule ``how``."""
    if how is None:
        return t
    if how == "heads":
        parts = t.reshape((3, tp, -1) + tuple(t.shape[1:]))[:, m]
        return parts.reshape((-1,) + tuple(t.shape[1:])).contiguous()
    dim = 0 if how == "col" else 1
    return t.chunk(tp, dim=dim)[m].contiguous()


def join(parts: Sequence[torch.Tensor], how: Optional[str]) -> torch.Tensor:
    """The whole tensor from its shards in model order (:func:`cut`'s
    inverse)."""
    if how is None:
        return parts[0]
    if how == "heads":
        tp = len(parts)
        rest = tuple(parts[0].shape[1:])
        stacked = torch.stack([p.reshape((3, -1) + rest) for p in parts], 1)
        return stacked.reshape((-1,) + rest)
    return torch.cat(list(parts), dim=0 if how == "col" else 1)


def cut_state(state: Dict[str, torch.Tensor], m: int, tp: int
              ) -> Dict[str, torch.Tensor]:
    """Shard m's state dict of a whole one."""
    return {k: cut(v, rule(k), m, tp) for k, v in state.items()}


def join_states(shards: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The whole state dict from the shards' state dicts in model order."""
    return {k: join([s[k] for s in shards], rule(k)) for k in shards[0]}


def cut_vit(vit: ViT3D, m: int, tp: int, device=None) -> ViT3D:
    """Shard m of tp of a whole ViT3D (quantized or not) as a ViT3D of
    :func:`shard_config`, its tensors cut from the whole, on ``device``
    (default: the whole one's)."""
    device = torch.device(device) if device is not None else next(
        iter(vit.state_dict().values())).device
    shard = ViT3D(shard_config(vit.cfg, tp), device="meta")
    if vit.quantized:
        quantize_blocks(shard)
    shard = shard.to_empty(device=device)
    shard.load_state_dict({k: v.to(device) for k, v in
                           cut_state(vit.state_dict(), m, tp).items()})
    return shard


def column_seed(key: int, m: int) -> int:
    """A column-parallel site's key on model index m: the site's key with
    m folded in, so no two shards draw one mask."""
    return nn.site_seed(key, -1 - m)


# ---------------------------------------------------------------------------
# Collectives over one replica's shards
# ---------------------------------------------------------------------------

class ProcessComm:
    """The model group of a training mesh: this process holds one shard."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.indices = [mesh.model_index]

    def _reduce(self, parts: List[torch.Tensor], op) -> List[torch.Tensor]:
        out = parts[0].contiguous().clone()
        dist.all_reduce(out, op=op, group=self.mesh.model_group)
        return [out]

    def sum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(parts, dist.ReduceOp.SUM)

    def max(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(parts, dist.ReduceOp.MAX)


class LocalComm:
    """A serving replica's cards within one process, one shard on each (a
    card may repeat): a collective combines the shards' tensors on the
    first card, in model order, and copies the result to each."""

    def __init__(self, devices: Sequence[Any]):
        self.devices = [torch.device(d) for d in devices]
        self.indices = list(range(len(self.devices)))

    def _reduce(self, parts: List[torch.Tensor], fn) -> List[torch.Tensor]:
        out = parts[0]
        for p in parts[1:]:
            out = fn(out, p.to(self.devices[0]))
        return [out.to(d) for d in self.devices]

    def sum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(parts, torch.add)

    def max(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(parts, torch.maximum)


def _sum_round(comm, parts: List[torch.Tensor], dtype) -> List[torch.Tensor]:
    """g's forward: the f32 partials summed over the model group and
    rounded to ``dtype`` once."""
    return [s.to(dtype) for s in comm.sum(parts)]


# ---------------------------------------------------------------------------
# The block ops on one shard, with their backwards (a process group)
# ---------------------------------------------------------------------------

class _LnQkvShard(torch.autograd.Function):
    """K2 on the shard's heads; the backward is K7's form and f: the f32
    partial dx summed over the model group, rounded once."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, heads, dim_head, comm):
        fwd = pick(fused_ln_qkv_plain, fused_ln_qkv_cuda,
                   fused_ln_qkv_f32_cuda, x, w_qkv)
        q, k, v, u = fwd(x, gamma, beta, w_qkv, heads, dim_head,
                         return_u=True)
        ctx.save_for_backward(x, gamma, w_qkv, u)
        ctx.comm = comm
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, gamma, w_qkv, u = ctx.saved_tensors
        b, n, _ = x.shape
        dqkv = torch.cat([t.reshape(b, n, -1) for t in (dq, dk, dv)], dim=2)
        dx, dgamma, dbeta = tp_forms.ln_qkv_bwd_partial(dqkv, x, gamma,
                                                        w_qkv)
        dx = _sum_round(ctx.comm, [dx], x.dtype)[0]
        dw = weight_grad(dqkv.reshape(b * n, -1),
                         u.reshape(b * n, -1)).to(w_qkv.dtype)
        return dx, dgamma, dbeta, dw, None, None, None


class _OutprojShard(torch.autograd.Function):
    """K3's form on the shard and g: y = x + Drop(a W^T + b) from the
    model group's f32 partials, rounded once. The backward is K8 on the
    shard's columns; x's gradient is dy (the residual is whole on every
    rank), b's is rank 0's."""

    @staticmethod
    def forward(ctx, x, attn, w_out, b_out, dropout_rate, seed, first, comm):
        part = tp_forms.outproj_partial(x, attn, w_out, b_out, first=first,
                                        dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(attn, w_out)
        ctx.args = dict(dropout_rate=dropout_rate, seed=seed)
        ctx.first = first
        return _sum_round(comm, [part], x.dtype)[0]

    @staticmethod
    def backward(ctx, dy):
        attn, w_out = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = pick(fused_outproj_bwd_plain, fused_outproj_bwd_cuda,
                   fused_outproj_bwd_f32_cuda, dy, w_out)
        dattn, dz = bwd(dy, w_out, **ctx.args)
        m = dy.shape[0] * dy.shape[1]
        dz2 = dz.reshape(m, -1)
        dw = weight_grad(dz2, attn.reshape(m, -1)).to(w_out.dtype)
        db = dz2.float().sum(0)
        if not ctx.first:
            db = torch.zeros_like(db)
        return dy, dattn, dw, db, None, None, None, None


class _MlpShard(torch.autograd.Function):
    """K4's form on the shard's hidden columns and g; the backward is K9's
    form and f: the f32 partial dx (rank 0's with dy) summed over the model
    group, rounded once."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, dropout_rate, seeds,
                first, comm):
        part, h = tp_forms.mlp_partial(x, gamma, beta, w1, b1, w2, b2,
                                       first=first, dropout_rate=dropout_rate,
                                       seeds=seeds, return_h=True)
        ctx.save_for_backward(x, h, gamma, beta, w1, w2)
        ctx.args = dict(dropout_rate=dropout_rate, seeds=seeds, first=first)
        ctx.comm = comm
        return _sum_round(comm, [part], x.dtype)[0]

    @staticmethod
    def backward(ctx, dy):
        x, h, gamma, beta, w1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        dx, u, a, dz, dh, dgamma, dbeta = tp_forms.mlp_bwd_partial(
            dy, x, h, gamma, beta, w1, w2, **ctx.args)
        dx = _sum_round(ctx.comm, [dx], x.dtype)[0]
        dw1 = weight_grad(dh, u).to(w1.dtype)
        dw2 = weight_grad(dz, a).to(w2.dtype)
        db1 = dh.float().sum(0)
        db2 = dz.float().sum(0)
        if not ctx.args["first"]:
            db2 = torch.zeros_like(db2)
        return (dx, dgamma, dbeta, dw1, db1, dw2, db2, None, None, None,
                None)


# ---------------------------------------------------------------------------
# A block over the shards this process holds
# ---------------------------------------------------------------------------

def _attention(attns, xs, comm, rate: float, seeds) -> List[torch.Tensor]:
    out = []
    if is_training(xs[0], attns[0].to_qkv.weight):
        (attn,), (x,), (m,) = attns, xs, comm.indices
        dt = x.dtype
        q, k, v = _LnQkvShard.apply(x, attn.norm.weight, attn.norm.bias,
                                    attn.to_qkv.weight.to(dt), attn.heads,
                                    attn.dim_head, comm)
        o = flash_attention(q, k, v, scale=attn.dim_head ** -0.5,
                            n_valid=x.shape[1], dropout_rate=rate,
                            seed=column_seed(seeds[0], m))
        proj = attn.to_out[0]
        return [_OutprojShard.apply(
            x, o.reshape(x.shape[0], x.shape[1], -1), proj.weight.to(dt),
            proj.bias, float(rate), int(seeds[1]), m == 0, comm)]
    for attn, x, m in zip(attns, xs, comm.indices):
        b, n, _ = x.shape
        q, k, v = fused_ln_qkv(x, attn.norm.weight, attn.norm.bias,
                               attn.to_qkv.weight.to(x.dtype), attn.heads,
                               attn.dim_head)
        o = flash_attention(q, k, v, scale=attn.dim_head ** -0.5, n_valid=n,
                            dropout_rate=rate, seed=column_seed(seeds[0], m))
        proj = attn.to_out[0]
        out.append(tp_forms.outproj_partial(
            x, o.reshape(b, n, -1), proj.weight.to(x.dtype), proj.bias,
            first=m == 0, dropout_rate=rate, seed=seeds[1]))
    return _sum_round(comm, out, xs[0].dtype)


def _feed_forward(ffs, xs, comm, rate: float, seeds) -> List[torch.Tensor]:
    def args(ff, x):
        norm, fc1, fc2 = ff.net[0], ff.net[1], ff.net[4]
        return (x, norm.weight, norm.bias, fc1.weight.to(x.dtype), fc1.bias,
                fc2.weight.to(x.dtype), fc2.bias)

    if is_training(xs[0], ffs[0].net[1].weight):
        (ff,), (x,), (m,) = ffs, xs, comm.indices
        keys = (column_seed(seeds[0], m), int(seeds[1]))
        return [_MlpShard.apply(*args(ff, x), float(rate), keys, m == 0,
                                comm)]
    parts = [tp_forms.mlp_partial(*args(ff, x), first=m == 0,
                                  dropout_rate=rate,
                                  seeds=(column_seed(seeds[0], m), seeds[1]))
             for ff, x, m in zip(ffs, xs, comm.indices)]
    return _sum_round(comm, parts, xs[0].dtype)


def _int8_attention(attns, xs, comm) -> List[torch.Tensor]:
    outs = []
    for attn, x in zip(attns, xs):
        b, n, _ = x.shape
        q, k, v = int8_ln_qkv(x, attn.norm_weight, attn.norm_bias,
                              attn.qkv_w8, attn.qkv_scale, attn.heads,
                              attn.dim_head)
        attend = (flash_attention if attn.int8_attn == "off"
                  else int8_flash_attention)
        outs.append(attend(q, k, v, scale=attn.dim_head ** -0.5,
                           n_valid=n).reshape(b, n, -1))
    amax = comm.max([tp_forms.int8_row_amax(o) for o in outs])
    accs = comm.sum([tp_forms.int8_outproj_partial(o, am, attn.out_w8)
                     for attn, o, am in zip(attns, outs, amax)])
    return [tp_forms.int8_dequant_residual(x, acc, am, attn.out_scale,
                                           attn.out_bias)
            for attn, x, acc, am in zip(attns, xs, accs, amax)]


def _int8_feed_forward(ffs, xs, comm) -> List[torch.Tensor]:
    hidden = [tp_forms.int8_mlp_hidden(x, ff.norm_weight, ff.norm_bias,
                                       ff.fc1_w8, ff.fc1_scale, ff.fc1_bias)
              for ff, x in zip(ffs, xs)]
    amax = comm.max([a for _, a in hidden])
    accs = comm.sum([tp_forms.int8_mlp_partial(state, am, ff.fc2_w8)
                     for ff, (state, _), am in zip(ffs, hidden, amax)])
    return [tp_forms.int8_dequant_residual(x, acc, am, ff.fc2_scale,
                                           ff.fc2_bias)
            for ff, x, acc, am in zip(ffs, xs, accs, amax)]


def tp_block(layers, xs: List[torch.Tensor], comm, rate: float,
             seeds: Sequence[int]) -> List[torch.Tensor]:
    """One block, attention then MLP, over the shards ``layers`` (each an
    (attention, feed-forward) pair of a shard ViT) and their copies ``xs``
    of the block's input; the block's output on each shard's device."""
    attns = [pair[0] for pair in layers]
    ffs = [pair[1] for pair in layers]
    if isinstance(attns[0], Int8Attention):
        if rate:
            raise ValueError("int8-quantized blocks are serving-only "
                             "(train=False)")
        return _int8_feed_forward(ffs, _int8_attention(attns, xs, comm),
                                  comm)
    xs = _attention(attns, xs, comm, rate, (seeds[0], seeds[1]))
    return _feed_forward(ffs, xs, comm, rate, (seeds[2], seeds[3]))


# ---------------------------------------------------------------------------
# Serving: one replica over cards of one process
# ---------------------------------------------------------------------------

class TensorParallelViT(tnn.Module):
    """One serving replica of a ViT3D over ``len(devices)`` cards of this
    process: shard m (:func:`cut_vit`) on ``devices[m]``, a card may repeat.
    The embedding and the head run on the first shard's card; every block
    runs on all shards (:func:`tp_block` with :class:`LocalComm`).
    Serving-only. ``vit`` may be quantized; it is not changed."""

    def __init__(self, vit: ViT3D, devices: Sequence[Any]):
        super().__init__()
        self.cfg = vit.cfg
        self.devices = [torch.device(d) for d in devices]
        tp = len(self.devices)
        self.shards = tnn.ModuleList(cut_vit(vit, m, tp, d)
                                     for m, d in enumerate(self.devices))

    @property
    def quantized(self) -> bool:
        return self.shards[0].quantized

    def forward(self, volume: torch.Tensor, *, train: bool = False,
                seed: Optional[int] = None) -> torch.Tensor:
        if train:
            raise ValueError("a tensor-parallel replica serves only "
                             "(train=False)")
        first = self.shards[0]
        comm = LocalComm(self.devices)
        with nn.full_f32(volume.dtype):
            x = first._embed(volume.to(self.devices[0]))
            xs = [x.to(d) for d in self.devices]
            for i in range(self.cfg.depth):
                xs = tp_block([s.transformer.layers[i] for s in self.shards],
                              xs, comm, 0.0, (0, 0, 0, 0))
            return first._head(xs[0])


# ---------------------------------------------------------------------------
# Training: this process's shard of a model, its state and its gradients
# ---------------------------------------------------------------------------

def shard_model_(model: tnn.Module, mesh) -> None:
    """Cut a NeuroEncoder's ViT to this process's shard, in place. The
    ResNet has no rule (``param_shardings`` matches none of its leaves) and
    stays whole."""
    if getattr(model, "encoder_kind", None) != "vit":
        return
    enc = model.volume_encoder
    frozen = not any(p.requires_grad for p in enc.parameters())
    enc.vit3d = cut_vit(enc.vit3d, mesh.model_index, mesh.model)
    if frozen:
        enc.requires_grad_(False)


def gather(t: torch.Tensor, key: str, mesh) -> torch.Tensor:
    """The whole tensor of state-dict key ``key`` (a parameter, its
    gradient or a moment) from every model rank's shard ``t`` (all ranks
    of the model group call this)."""
    return _gather(t, rule(key), mesh)


def _gather(t: torch.Tensor, how: Optional[str], mesh) -> torch.Tensor:
    if how is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return join(parts, how)


def whole_state_dict(model: tnn.Module, mesh) -> Dict[str, torch.Tensor]:
    """A sharded model's whole state dict, a one-process model's keys and
    shapes, on every rank of the model group."""
    return {k: _gather(v, rule(k), mesh)
            for k, v in model.state_dict().items()}


def load_whole_state_dict(model: tnn.Module, state: Dict[str, torch.Tensor],
                          mesh, strict: bool = True):
    """Load a whole state dict into this process's shard of ``model``."""
    return model.load_state_dict(
        cut_state(state, mesh.model_index, mesh.model), strict=strict)


def _moment_rules(model: tnn.Module) -> List[Optional[str]]:
    """The rule of each trainable parameter in the optimizer's order."""
    return [rule(n) for n, p in model.named_parameters() if p.requires_grad]


def whole_optimizer_state(adamw: Dict[str, Any], model: tnn.Module,
                          mesh) -> Dict[str, Any]:
    """An AdamW state dict of a sharded model with its moments whole."""
    rules = _moment_rules(model)
    state = {i: {k: _gather(v, rules[i], mesh) if k.startswith("exp_avg")
                 else v for k, v in st.items()}
             for i, st in adamw["state"].items()}
    return {**adamw, "state": state}


def cut_optimizer_state(adamw: Dict[str, Any], model: tnn.Module,
                        mesh) -> Dict[str, Any]:
    """A whole AdamW state dict with each moment cut to this process's
    shard of its parameter (``place_opt_state``)."""
    rules = _moment_rules(model)
    state = {i: {k: cut(v, rules[int(i)], mesh.model_index, mesh.model)
                 if k.startswith("exp_avg") else v for k, v in st.items()}
             for i, st in adamw["state"].items()}
    return {**adamw, "state": state}


@torch.no_grad()
def reduce_partial_grads(model: tnn.Module, mesh) -> None:
    """Sum over the model group the gradients each model rank holds in
    part (:func:`partial_names`), one collective."""
    names = dict(model.named_parameters())
    grads = [names[n].grad for n in partial_names(names)
             if names[n].grad is not None]
    if grads:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.model_group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
