"""Profiling: a ``torch.profiler`` trace context and per-step timing.

Counterpart of ``neurovit_tpu/utils/profiling.py``: ``trace(log_dir)``
records the host's operators, and the card's kernels when a card is in use,
into a Chrome trace under ``log_dir`` (viewable in Perfetto or
chrome://tracing); ``StepTimer`` keeps per-step wall-clock statistics with
the device waited on only once, at ``summary()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "./results/profile", cuda: Optional[bool] = None):
    """Capture a trace: ``with trace(): run_steps()``. ``cuda`` (default:
    whether a card is available) adds the card's activity; the card is
    synchronised before the trace stops, so every kernel launched inside
    is in it. Yields the profiler. The trace is written on exit, also when
    the body raises, as ``<host>.<pid>.<ns>.pt.trace.json`` (the name
    ``torch.profiler.tensorboard_trace_handler`` gives), so two traces of
    one run do not overwrite each other."""
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{os.uname().nodename}.{os.getpid()}."
            f"{time.time_ns()}.pt.trace.json"))


class StepTimer:
    """Wall-clock per-step stats. Call mark() after each dispatched step;
    summary() waits for the last result and reports mean/p50/p95."""

    def __init__(self):
        self._times: List[float] = []
        self._last = None

    def mark(self, result=None) -> None:
        self._times.append(time.perf_counter())
        self._last = result

    def summary(self) -> Optional[Dict[str, float]]:
        if self._last is not None:
            _wait(self._last)
            self._times.append(time.perf_counter())
            self._last = None
        if len(self._times) < 2:
            return None
        deltas = np.diff(self._times)
        return {
            "steps": int(len(deltas)),
            "mean_s": float(deltas.mean()),
            "p50_s": float(np.percentile(deltas, 50)),
            "p95_s": float(np.percentile(deltas, 95)),
            "steps_per_sec": float(1.0 / max(deltas.mean(), 1e-12)),
        }

    def reset(self) -> None:
        self._times.clear()
        self._last = None


def _wait(result) -> None:
    """Wait until ``result`` (a tensor, or a dict, list or tuple of them) is
    computed: ``torch.cuda.synchronize()`` for a CUDA tensor; a CPU tensor
    is ready when its op returns."""
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            _wait(item)
    elif isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.synchronize(result.device)
