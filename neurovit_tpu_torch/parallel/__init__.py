"""Multi-GPU parallelism: the mesh, the process group, the collectives.

Counterpart of ``neurovit_tpu/parallel/__init__.py``, its data- and
tensor-parallel halves: training runs one process per GPU under
``torchrun`` (NCCL on the cards, gloo on the CPU), each data index on its
rows of the global batch with the gradients summed once per optimizer
step; with ``MESH_MODEL_AXIS > 1`` the ranks of one data index hold the
shards of the ViT blocks (``tensor_parallel``, Megatron-style); serving
with ``--mesh`` keeps one replica on each card of one process, or one
tensor-parallel replica on each ``MESH_MODEL_AXIS`` of them. The GPipe
pipeline (``MESH_PIPE_AXIS > 1``, ``pipeline.py``) is not ported and
raises. ``tensor_parallel`` is imported where it is used: it imports the
model.
"""

from neurovit_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, create_mesh, current_mesh,
    use_mesh,
)
from neurovit_tpu_torch.parallel import distributed  # noqa: F401
from neurovit_tpu_torch.parallel import sharding  # noqa: F401
