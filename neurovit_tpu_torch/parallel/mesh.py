"""The (data, model, pipe) mesh over the processes or the cards.

Counterpart of ``neurovit_tpu/parallel/mesh.py:17-40``. JAX builds one
``jax.sharding.Mesh`` over every device of the run; PyTorch runs one
process per GPU in training (``torchrun``), so a training mesh counts
processes, and its data axis is the default process group. A serving mesh
lies within one process (the JAX server is single-host too): it counts the
cards the process serves on, one model replica on each.

``MESH_DATA_AXIS == -1`` (the default) puts every device on the data axis,
pure data parallelism. ``MESH_MODEL_AXIS > 1`` (tensor parallelism) and
``MESH_PIPE_AXIS > 1`` (pipeline parallelism) are not ported and raise.

``use_mesh`` is ``jax.set_mesh``'s counterpart: the trainer runs its steps
inside it, and the model's data-parallel parts (the ResNet's global
BatchNorm statistics, the 4D model's split B·T stream) read it through
:func:`current_mesh`. Outside it the model runs on its own rows.
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
    ``devices``: a serving mesh's cards, one replica each, on the data
    axis; None for a training mesh. ``rank`` and ``group``: this
    process's place on a training mesh's data axis and the process group
    the axis spans (None within one process)."""

    shape: Dict[str, int]
    devices: Optional[tuple] = None
    rank: int = 0
    group: Any = None

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def distributed(self) -> bool:
        """Whether the data axis spans processes, so collectives run (at
        world size 1 too)."""
        return self.group is not None


def create_mesh(config: Optional[Dict[str, Any]] = None,
                world: Union[int, Sequence[Any], None] = None) -> Mesh:
    """A (data, model, pipe) mesh over ``world``: the number of processes
    of the run (default: the default process group's size, 1 without
    one), or a sequence of devices for a serving mesh. The rule and the
    errors are JAX's; a model or pipe axis above 1 raises first."""
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
    if model > 1 or pipe > 1:
        raise not_ported(
            f"a mesh with MESH_MODEL_AXIS={model} x MESH_PIPE_AXIS={pipe} "
            "(tensor parallelism and pipeline parallelism; the data axis "
            "runs)", "multi-GPU")
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
    return Mesh(shape, rank=distributed.rank(), group=distributed.group())


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
    """The mesh of the enclosing :func:`use_mesh` when its data axis spans
    processes, else None."""
    if _current is not None and _current.distributed:
        return _current
    return None
