"""Metric logging: wandb when available, local JSONL always.

Counterpart of ``neurovit_tpu/training/metrics.py`` (the JAX package's
``training`` imports its JAX trainer, so the port carries its own copy).
The reference logs train metrics every 10% of batches and val metrics per
epoch to wandb (``src/Trainer.py:89-99,114-118``; ``main.py:133-138``). The
logger writes the same records to a local JSONL run file and forwards them
to wandb when the package exists and WANDB_ENABLED is set. In a
multi-process run rank 0 alone logs; the other ranks' loggers write
nothing and start no wandb run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from neurovit_tpu_torch.parallel import distributed


class MetricLogger:
    def __init__(self, config: Dict[str, Any], run_dir: Optional[str] = None):
        self.config = config
        self.active = distributed.is_writer()
        self.enabled = bool(config.get("WANDB_ENABLED", False)) and self.active
        self._wandb = None
        self._fh = None
        if not self.active:
            return
        if self.enabled:
            try:
                import wandb  # type: ignore
                wandb.init(project="NeuroViT", mode="online",
                           config=config, name=config.get("NAME"))
                self._wandb = wandb
            except ImportError:
                pass  # fall through to JSONL-only
        run_dir = run_dir or config.get("GLOBAL_OUTPUT_DIR", "./results/runs")
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self._path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        if not self.active:
            return
        record = dict(record, _ts=time.time())
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            rec = {k: v for k, v in record.items() if not k.startswith("_")}
            self._wandb.log(rec)

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
