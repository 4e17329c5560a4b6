"""AdamW with the JAX package's learning-rate schedules and accumulation.

Counterpart of ``neurovit_tpu/training/optim.py``:
``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8, weight_decay=...)`` over
every trainable parameter (the whole model in 3D), and
``TRAINING_LR_SCHEDULE``:

- constant: the configured LR;
- cosine: cosine decay from the LR to 0 over epochs * steps_per_epoch /
  accumulation optimizer steps (optim.py:34-37, optax's
  ``cosine_decay_schedule`` with alpha 0);
- plateau: the configured LR until the Trainer lowers it with ``set_lr``.

``TRAINING_ACCUMULATION_STEP`` = k has optax ``MultiSteps``'s semantics:
the gradients of k micro-batches are averaged and one optimizer step is
taken; parameters do not move in between. In data parallelism the
gradients are reduced over the ranks once a window, before the update
(``before_update``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import torch

SCHEDULES = ("constant", "cosine", "plateau")


class Optimizer:
    """Wraps ``torch.optim.AdamW``. Call :meth:`step` after each
    micro-batch's backward; it returns whether the parameters moved."""

    def __init__(self, config: Dict[str, Any],
                 params: Iterable[torch.nn.Parameter], steps_per_epoch: int):
        self.schedule = config.get("TRAINING_LR_SCHEDULE", "constant")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown TRAINING_LR_SCHEDULE {self.schedule!r} "
                             f"(supported: {', '.join(SCHEDULES)})")
        self.base_lr = float(config["TRAINING_LEARNING_RATE"])
        self.accum = max(1, int(config.get("TRAINING_ACCUMULATION_STEP", 1)))
        epochs = int(config.get("TRAINING_EPOCHS", 1))
        self.decay_steps = max(1, epochs * steps_per_epoch // self.accum)
        self.params = [p for p in params if p.requires_grad]
        self.opt = torch.optim.AdamW(
            self.params, lr=self.base_lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(config.get("TRAINING_WEIGHT_DECAY", 0.01)))
        # Called with the parameters once a window is full, before the
        # update: the data-parallel gradient reduction.
        self.before_update: Optional[Callable[[list], None]] = None
        self.steps = 0          # optimizer steps taken
        self.micro = 0          # micro-batches accumulated since the last
        self.lr = self._scheduled(0)

    def _scheduled(self, step: int) -> float:
        if self.schedule == "cosine":
            t = min(step, self.decay_steps) / self.decay_steps
            return self.base_lr * 0.5 * (1.0 + math.cos(math.pi * t))
        return self.base_lr

    def current_lr(self) -> float:
        """The LR of the last optimizer step (before the first, the first
        step's), as the JAX trainer logs it."""
        return self.lr

    def set_lr(self, lr: float) -> None:
        """Override the LR of the following steps (the plateau schedule)."""
        self.base_lr = float(lr)
        self.lr = float(lr)

    def step(self) -> bool:
        self.micro += 1
        if self.micro < self.accum:
            return False
        if self.before_update is not None:
            self.before_update(self.params)
        if self.accum > 1:
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(self.accum)
        self.lr = self._scheduled(self.steps)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.steps += 1
        self.micro = 0
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.opt.state_dict(), "steps": self.steps,
                "micro": self.micro, "base_lr": self.base_lr, "lr": self.lr}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.steps = int(state["steps"])
        self.micro = int(state["micro"])
        self.base_lr = float(state["base_lr"])
        self.lr = float(state["lr"])
