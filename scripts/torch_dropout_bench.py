"""Isolated dropout benchmark of the port: K16, the fused dropout kernel,
forward and gradient, beside the port's ``nn.dropout`` (the model's q/256
dropout, plain torch) and ``torch.nn.functional.dropout``.

The PyTorch port of ``scripts/dropout_bench.py``: x [32 * 1001, 2048] bf16
from ``np.random.RandomState(0)``, rate 0.1, the forward and the gradient
of sum(dropout(x)^2), and the keep fraction of K16's forward. On the card
each time is the median of CUDA-event timings after a warm-up; with
``--device cpu`` the plain versions run and the host clock times them.

    python scripts/torch_dropout_bench.py [--device cuda|cpu] [--iters 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch import nn  # noqa: E402
from neurovit_tpu_torch.ops import dropout as k16  # noqa: E402

M, C = 32 * 1001, 2048
RATE = 0.1


def median_ms(fn, device: str, iters: int) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` timings after two
    warm-up calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _grad(drop):
    """The gradient of sum(drop(x)^2) in f32, as the JAX script takes it."""
    def fn(x):
        x = x.detach().requires_grad_()
        (drop(x).float() ** 2).sum().backward()
        return x.grad
    return fn


def run(device: str = "cuda", rows: int = M, cols: int = C,
        iters: int = 20, seed: int = 0) -> dict:
    """Times (ms) of K16's forward and gradient and of the two others at
    [rows, cols] bf16, and K16's keep fraction beside its expectation."""
    x = torch.tensor(np.random.RandomState(0).randn(rows, cols),
                     dtype=torch.bfloat16, device=device)
    paths = {
        "k16": lambda t: k16.dropout(t, RATE, seed),
        "nn.dropout": lambda t: nn.dropout(t, RATE, seed),
        "F.dropout": lambda t: F.dropout(t, RATE, training=True),
    }
    out = {}
    for name, drop in paths.items():
        out[f"{name} fwd"] = median_ms(lambda: drop(x), device, iters)
        grad = _grad(drop)
        out[f"{name} grad"] = median_ms(lambda: grad(x), device, iters)
    threshold, _ = k16.keep_threshold32(RATE)
    out["keep fraction"] = float((k16.dropout(x, RATE, seed) != 0).float()
                                 .mean())
    out["keep expected"] = threshold / 2.0 ** 32
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_dropout_bench: CUDA is not available (--device cpu runs "
              "the plain versions)", file=sys.stderr)
        return 1
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"device: {where}; x [{M}, {C}] bf16, rate {RATE}")
    res = run(args.device, iters=args.iters)
    for name in ("k16", "nn.dropout", "F.dropout"):
        print(f"{name:10s} fwd : {res[name + ' fwd']:8.3f} ms")
        print(f"{name:10s} grad: {res[name + ' grad']:8.3f} ms")
    print(f"keep fraction {res['keep fraction']:.4f} (expected "
          f"{res['keep expected']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
