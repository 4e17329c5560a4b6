"""Training: the trainer, its optimizer and logger, and checkpoints that
interchange with the JAX package."""

from neurovit_tpu_torch.training.metrics import MetricLogger  # noqa: F401
from neurovit_tpu_torch.training.trainer import Trainer  # noqa: F401
