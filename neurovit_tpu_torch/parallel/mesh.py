"""The (data, model, pipe) mesh over the processes or the cards.

Counterpart of ``neurovit_tpu/parallel/mesh.py:17-40``. JAX builds one
``jax.sharding.Mesh`` over every device of the run; PyTorch runs one
process per GPU in training (``torchrun``), so a training mesh counts
processes. A serving mesh lies within one process (the JAX server is
single-host too): it counts the cards the process serves on.

``MESH_DATA_AXIS == -1`` (the default) puts every device left on the data
axis. ``MESH_MODEL_AXIS > 1`` is tensor parallelism (``tensor_parallel``):
JAX reshapes its devices to (data, model, pipe) with the model axis inner,
so rank r of a training mesh sits at data index r // model and model index
r % model, and one tensor-parallel group is consecutive ranks. The mesh
holds this process's indices and two subgroups of the process group: the
data group (the ranks of its model index) and the model group (the ranks of
its data index). A serving mesh reshapes its cards the same way: replica i
holds its shards on ``devices[i * model:(i + 1) * model]``, and a card may
repeat. ``MESH_PIPE_AXIS > 1`` (pipeline parallelism) is not ported and
raises.

``use_mesh`` is ``jax.set_mesh``'s counterpart: the trainer runs its steps
inside it, and the model's parallel parts (the ViT blocks' shards, the
ResNet's global BatchNorm statistics, the 4D model's split B·T stream) read
it through :func:`current_mesh`. Outside it the model runs on its own rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> size, as ``jax.sharding.Mesh.shape``.
    ``devices``: a serving mesh's cards, data-major (replica i on
    ``devices[i * model:(i + 1) * model]``); None for a training mesh.
    ``rank`` and ``group``: this process's index on the data axis and the
    process group the axis spans; ``model_index`` and ``model_group`` the
    same on the model axis (None without a model axis above 1). Both groups
    are None within one process, where nothing runs a collective."""

    shape: Dict[str, int]
    devices: Optional[tuple] = None
    rank: int = 0
    group: Any = None
    model_index: int = 0
    model_group: Any = None

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def distributed(self) -> bool:
        """Whether the data axis spans processes, so collectives run (at
        world size 1 too)."""
        return self.group is not None


def _subgroups(data: int, model: int, rank: int):
    """(data group, model group) of ``rank`` on a (data, model) mesh of
    the default group's ranks, model inner. Every rank makes every group,
    in one order, as ``new_group`` asks."""
    import torch.distributed as dist
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def create_mesh(config: Optional[Dict[str, Any]] = None,
                world: Union[int, Sequence[Any], None] = None) -> Mesh:
    """A (data, model, pipe) mesh over ``world``: the number of processes
    of the run (default: the default process group's size, 1 without
    one), or a sequence of devices for a serving mesh. The rule and the
    errors are JAX's; a pipe axis above 1 raises first."""
    from neurovit_tpu_torch.models.neuro_encoder import not_ported
    from neurovit_tpu_torch.parallel import distributed

    devices = None
    if world is None:
        world = distributed.world_size()
    if not isinstance(world, int):
        devices = tuple(world)
        world = len(devices)
    elif world not in (1, distributed.world_size()):
        raise ValueError(
            f"a training mesh of {world} devices runs {world} processes "
            f"(torchrun --nproc_per_node={world}); this run has "
            f"{distributed.world_size()}")
    n = world
    model = int(config.get("MESH_MODEL_AXIS", 1)) if config else 1
    pipe = int(config.get("MESH_PIPE_AXIS", 1)) if config else 1
    data = int(config.get("MESH_DATA_AXIS", -1)) if config else -1
    if pipe > 1:
        raise not_ported(
            f"a mesh with MESH_PIPE_AXIS={pipe} (pipeline parallelism; the "
            "data and model axes run)", "multi-GPU")
    if model < 1 or pipe < 1 or n % (model * pipe) != 0:
        raise ValueError(f"MESH_MODEL_AXIS={model} x MESH_PIPE_AXIS={pipe} "
                         f"does not divide {n} devices")
    if data == -1:
        data = n // (model * pipe)
    if data * model * pipe != n:
        raise ValueError(f"mesh {data}x{model}x{pipe} != {n} devices")
    shape = {DATA_AXIS: data, MODEL_AXIS: model, PIPE_AXIS: pipe}
    if devices is not None:
        return Mesh(shape, devices=devices)
    if n == 1 and distributed.world_size() > 1:
        return Mesh(shape)            # one process of a larger group
    rank = distributed.rank()
    if model == 1:
        return Mesh(shape, rank=rank, group=distributed.group())
    data_group, model_group = _subgroups(data, model, rank)
    return Mesh(shape, rank=rank // model, group=data_group,
                model_index=rank % model, model_group=model_group)


_current: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Inside the block, :func:`current_mesh` is ``mesh``; the previous
    one after."""
    global _current
    previous, _current = _current, mesh
    try:
        yield mesh
    finally:
        _current = previous


def current_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`use_mesh` when its axes span
    processes, else None."""
    if _current is not None and _current.distributed:
        return _current
    return None
