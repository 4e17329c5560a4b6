"""The process group of a multi-GPU run: one process per GPU.

Counterpart of ``neurovit_tpu/parallel/distributed.py:31-89``. JAX starts
its coordination service for a multi-host pod; PyTorch's idiom is one
process per GPU, started by ``torchrun``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``:

    torchrun --standalone --nproc_per_node=N -m neurovit_tpu_torch.main ...

Each process feeds its own rows (the loader's ``shard=(rank, world)``),
as each JAX host does (distributed.py:12-18).

:func:`maybe_initialize` starts the default process group when such a
run is asked for: by torchrun's variables, or by the ``DISTRIBUTED_*``
keys the JAX package reads with ``config.get`` (``DISTRIBUTED_MULTIHOST``,
``DISTRIBUTED_COORDINATOR`` as ``host:port``,
``DISTRIBUTED_NUM_PROCESSES``, ``DISTRIBUTED_PROCESS_ID``; none is in
the defaults). NCCL runs the collectives of CUDA devices and gloo those of
the CPU; a failed NCCL start raises, it is never retried on gloo. A group
that already exists is adopted, as JAX accepts "already initialized"
(distributed.py:54-58). In a single process nothing starts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_TORCHRUN_ENVS = ("RANK", "WORLD_SIZE")


def requested(config: Optional[Dict[str, Any]] = None) -> bool:
    """Whether a multi-process run is asked for (distributed.py:31-34)."""
    if config and config.get("DISTRIBUTED_MULTIHOST", False):
        return True
    return all(os.environ.get(k) is not None for k in _TORCHRUN_ENVS)


def maybe_initialize(config: Optional[Dict[str, Any]] = None,
                     device: Optional[torch.device] = None) -> bool:
    """Start (or adopt) the default process group; True when one exists
    after the call. ``device``: this process's device, which picks the
    backend (NCCL for CUDA, gloo for the CPU)."""
    if dist.is_initialized():
        return True
    if not requested(config):
        return False
    device = torch.device(device if device is not None else "cpu")
    env = os.environ
    rank = (env.get("RANK") if env.get("RANK") is not None
            else (config or {}).get("DISTRIBUTED_PROCESS_ID"))
    world = (env.get("WORLD_SIZE") if env.get("WORLD_SIZE") is not None
             else (config or {}).get("DISTRIBUTED_NUM_PROCESSES"))
    if rank is None or world is None:
        raise ValueError("a multi-process run needs RANK and WORLD_SIZE "
                         "(torchrun sets them) or DISTRIBUTED_PROCESS_ID "
                         "and DISTRIBUTED_NUM_PROCESSES")
    init_method = "env://"
    coordinator = (config or {}).get("DISTRIBUTED_COORDINATOR")
    if env.get("MASTER_ADDR") is None and coordinator:
        init_method = f"tcp://{coordinator}"
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(rank), world_size=int(world))
    # The first collective starts NCCL's communicator: a failure raises
    # here, not at the first gradient.
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != int(world):
        raise RuntimeError(f"process group probe summed to {probe.item()}, "
                           f"not the world size {world}")
    return True


def group() -> Any:
    """The default process group, or None outside one."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 alone."""
    return rank() == 0


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
