"""Multi-GPU data parallelism: the mesh, the process group, the collectives.

Counterpart of ``neurovit_tpu/parallel/__init__.py``, its data-parallel
half: training runs one process per GPU under ``torchrun`` (NCCL on the
cards, gloo on the CPU), each rank on its rows of the global batch with
the gradients summed once per optimizer step; serving with ``--mesh``
keeps one replica of the model on each card of one process. Tensor
parallelism (``MESH_MODEL_AXIS > 1``) and the GPipe pipeline
(``MESH_PIPE_AXIS > 1``, ``pipeline.py``) are not ported and raise.
"""

from neurovit_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, create_mesh, current_mesh,
    use_mesh,
)
from neurovit_tpu_torch.parallel import distributed  # noqa: F401
from neurovit_tpu_torch.parallel import sharding  # noqa: F401
