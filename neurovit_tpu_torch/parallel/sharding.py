"""Data parallelism over a mesh's data axis: rows, padding, collectives.

Counterpart of the data-parallel half of
``neurovit_tpu/parallel/sharding.py:18-66``. XLA inserts JAX's collectives
from the shardings; here they are written out:

- a global batch's rows: ``TRAINING_BATCH_SIZE`` is the global batch, and
  data index d holds rows d, d + data, d + 2 data, ... of it, which is what
  the loader's strided ``shard=(d, data)`` gives at every step
  (:func:`local_rows`); a batch is first padded to a multiple of the data
  axis, its pad rows repeating the last volume with label 0 and ``valid``
  False (:func:`pad_batch`, trainer.py:711-721);
- per-sample outputs back in the global batch's order
  (:func:`gather_rows`), or a contiguous split stream back in order
  (:func:`gather_stream`, the 4D B·T stream);
- the parameter broadcast from rank 0 (:func:`broadcast_module`), at the
  start and after a restore;
- one coalesced reduction of the gradients per optimizer step
  (:func:`reduce_grads`), and the metric sums (:func:`all_reduce_sum`);
- :func:`global_sum`, a sum over the ranks that autograd differentiates
  (the ResNet's global BatchNorm statistics).

JAX's ``param_shardings`` and ``place_opt_state`` are replication on a
mesh whose model axis is 1: every rank holds the whole model and its AdamW
state, kept equal by the broadcast and the reduced gradients. On a model
axis above 1 the ranks of one data group hold one shard
(``tensor_parallel``, the tensor-parallel rules of sharding.py:69-173),
and these collectives run over the data group.

A gather is written as a sum of zero-filled buffers, one row block filled
by each rank: exact, and every backend (NCCL, and gloo on CPU and CUDA
tensors alike) runs ``all_reduce``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.parallel.mesh import Mesh

SEED_HIGH = 2 ** 63 - 1


def pad_batch(batch: Dict[str, Any], world: int) -> Dict[str, Any]:
    """A host batch's array fields padded to a multiple of ``world`` rows:
    pad rows repeat the last volume, their label is 0 and ``valid`` is
    False (trainer.py:711-721). Other fields pass through."""
    b = len(batch["valid"])
    pad = (-b) % world
    if not pad:
        return dict(batch)
    out = dict(batch)
    out["volume"] = np.concatenate(
        [batch["volume"], np.repeat(batch["volume"][-1:], pad, axis=0)])
    out["label"] = np.concatenate(
        [np.asarray(batch["label"]), np.zeros(pad, np.asarray(
            batch["label"]).dtype)])
    out["valid"] = np.concatenate([np.asarray(batch["valid"], np.bool_),
                                   np.zeros(pad, np.bool_)])
    return out


def local_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global host batch, padded first: rows
    rank, rank + world, ... (the rows the strided loader shard gives this
    rank). Array fields are sliced; lists are sliced alike."""
    world, rank = mesh.data, mesh.rank
    out = {}
    for key, value in pad_batch(batch, world).items():
        if isinstance(value, (np.ndarray, torch.Tensor, list)) and \
                len(value) % world == 0:
            out[key] = value[rank::world]
        else:
            out[key] = value
    return out


def _gathered(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[world, *t.shape]: slot r holds rank r's ``t`` on every rank."""
    buf = torch.zeros((mesh.data,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    buf[mesh.rank] = t
    dist.all_reduce(buf, group=mesh.group)
    return buf


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per-sample outputs [b, ...] of every rank's strided rows -> the
    global batch's [world * b, ...] in its own order, on every rank."""
    buf = _gathered(t, mesh)
    return buf.transpose(0, 1).reshape((-1,) + tuple(t.shape[1:]))


def gather_stream(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's contiguous part [n, ...] of a split stream -> the whole
    stream [world * n, ...] in order, on every rank."""
    return _gathered(t, mesh).reshape((-1,) + tuple(t.shape[1:]))


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` is kept)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks'
    gradients: every rank's loss depends on the global sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable (SyncBatchNorm's
    contract: the backward sums the ranks' gradients of the sums)."""
    return _GlobalSum.apply(t, mesh.group)


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[Any, List]:
    groups: Dict[Any, List] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _flat_collective(tensors: List[torch.Tensor], op) -> None:
    """Run ``op`` on one flat buffer per dtype of ``tensors``, then copy
    the buffer back into them."""
    for same in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in same])
        op(flat)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Mesh,
                     group: Any = None) -> None:
    """Rank 0's parameters and buffers (the BatchNorm running statistics
    among them) into every rank's ``module``, over the data group or
    ``group``."""
    group = mesh.group if group is None else group
    tensors = list(module.parameters()) + list(module.buffers())
    src = dist.get_global_rank(group, 0)
    _flat_collective([t.data for t in tensors],
                     lambda flat: dist.broadcast(flat, src, group=group))


@torch.no_grad()
def reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh, *,
                 replicated: bool = False, group: Any = None) -> None:
    """One coalesced collective on the gradients of ``params``: their sum
    over the data group (each rank's loss is its share of the global
    loss), or, for a ``replicated`` batch that every rank computed whole,
    rank 0's gradients on every rank of the data group or ``group``."""
    grads = [p.grad for p in params if p.grad is not None]
    if replicated:
        group = mesh.group if group is None else group
        src = dist.get_global_rank(group, 0)
        op = lambda flat: dist.broadcast(flat, src,  # noqa: E731
                                         group=group)
    else:
        op = lambda flat: dist.all_reduce(flat,  # noqa: E731
                                          group=mesh.group)
    _flat_collective(grads, op)


def rank_seed(seed: int, rank: int) -> int:
    """The step seed rank ``rank`` draws its dropout masks from: rank 0
    keeps the step's seed, so one process draws what it always drew; rank
    r > 0 folds r in, so no two ranks draw the same masks for their rows."""
    if rank == 0:
        return seed
    return nn.site_seed(seed, -1 - rank) & SEED_HIGH
