"""Device-only times of the ResNet stem's pool: K14 (the forward with its
argmax codes) and K15 (the backward through them), beside PyTorch's own
pool and its backward.

``chip_smoke.py`` times a call with CUDA events around it, which also
counts the host's enqueue. This script reads the device's own kernel times
from ``torch.profiler`` (``device_us`` of
``scripts/torch_gemm_device_times.py``) at the stem's pool input [B, 90,
45, 45, 64] bf16 NDHWC, batch 8 and 64:

- K14 on seeded standard-normal x; K15 on its codes and a seeded g;
- ``F.max_pool3d(x, 3, 2, 1, return_indices=True)`` on x's NCDHW view
  (channels-last), and ``aten.max_pool3d_with_indices_backward`` on g's
  view and those indices: one PyTorch call each computing the same values
  (its ties and codes differ: ROADMAP.md, Queue 3).

Each line gives the function's bound (its bytes at 3.35 TB/s: K14 reads x
and writes out and the codes, K15 reads the codes and g and writes dx),
the device time, the median one-call CUDA-event time and the host's
enqueue time per call.

    python scripts/torch_pool_device_times.py [--iters 20] [--batches 8 64]

Needs the card; prints nvidia-smi's name and power limit first. Copied
into an older checkout's ``scripts/``, it times that checkout's kernels
(the wrappers take the same arguments).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.ops import maxpool3d as mp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attention_device_times import events_ms  # noqa: E402
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

STEM = (90, 45, 45, 64)
BATCHES = (8, 64)
HBM_BYTES_PER_S = 3.35e12


def operands(b: int, seed: int = 42) -> dict:
    """x [b, 90, 45, 45, 64] bf16 (standard normal), K14's codes of it and
    a standard-normal g of the pool's output shape, all seeded."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, *STEM)), dtype=torch.bfloat16,
                     device="cuda")
    _, codes = mp.max_pool3d_argmax_cuda(x)
    g = torch.tensor(rng.standard_normal(tuple(codes.shape)),
                     dtype=torch.bfloat16, device="cuda")
    return {"x": x, "codes": codes, "g": g}


def bound_ms(ops: dict) -> float:
    """Both kernels move the same bytes: x (dx) at 2 bytes, out (g) at 2
    and the codes at 1 per output element."""
    x, g, codes = ops["x"], ops["g"], ops["codes"]
    nbytes = 2 * x.numel() + 2 * g.numel() + codes.numel()
    return nbytes / HBM_BYTES_PER_S * 1e3


def calls(ops: dict) -> dict:
    """name -> one call: K14, K15 and the two PyTorch yardsticks."""
    x, g, codes = ops["x"], ops["g"], ops["codes"]
    xv = x.permute(0, 4, 1, 2, 3)
    _, idx = F.max_pool3d(xv, 3, 2, 1, return_indices=True)
    gv = g.permute(0, 4, 1, 2, 3)
    return {
        "K14": lambda: mp.max_pool3d_argmax_cuda(x),
        "K15": lambda: mp.max_pool3d_argmax_bwd_cuda(codes, g, x.shape,
                                                     x.dtype),
        "F.max_pool3d": lambda: F.max_pool3d(xv, 3, 2, 1,
                                             return_indices=True),
        "max_pool3d_with_indices_backward":
            lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                gv, xv, [3] * 3, [2] * 3, [1] * 3, [1] * 3, False, idx),
    }


def measure(call, iters: int) -> dict:
    """Device microseconds of each kernel of one call and their sum in ms
    ({} and None where the trace held no kernels), the median one-call
    CUDA-event ms, and the host's enqueue microseconds a call."""
    passes = {key[:48]: us for key, us in device_us(call, iters).items()}
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "events_ms": events_ms(call),
            "enqueue_us": enqueue_us(call, 4 * iters)}


def line(what: str, m: dict, bound: float) -> str:
    if not m["passes_us"]:
        head = f"{what}: device not measured (no kernels traced)"
    else:
        parts = ", ".join(f"{p} {us:.1f}" for p, us in m["passes_us"].items())
        head = (f"{what}: device {m['device_ms']:.4f} ms ({parts} us; "
                f"{bound / m['device_ms']:.2f} of the bound)")
    return (f"{head}; events {m['events_ms']:.4f} ms; bound {bound:.4f} ms "
            f"(bytes); enqueue {m['enqueue_us']:.1f} us a call")


def run(b: int, iters: int) -> tuple:
    """(lines, measured) at batch b: a line for each call, each call's
    :func:`measure` by name."""
    ops = operands(b)
    bound = bound_ms(ops)
    lines, measured = [], {}
    for name, call in calls(ops).items():
        measured[name] = measure(call, iters)
        lines.append(line(f"{name} batch {b} [{b}, 90, 45, 45, 64] bf16",
                          measured[name], bound))
    return lines, measured


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pool_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for b in args.batches:
        for text in run(b, args.iters)[0]:
            print(text, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
