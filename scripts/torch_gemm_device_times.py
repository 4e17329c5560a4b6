"""Device-only times of K17/K18 and their library yardsticks, by kernel.

``scripts/torch_int8_gemm_bench.py`` and ``chip_smoke.py`` time a call with
CUDA events around it, which on a slow host also counts the wrapper's
enqueue. This script reads the device's own kernel times from
``torch.profiler`` instead: for each of the probe's seven shapes, the
transpose step and the GEMM kernel of K17 bf16, K17 int8 and K18, and the
kernels of ``torch.matmul`` (bf16 out), ``torch.mm(..., out_dtype=
torch.float32)`` where this PyTorch has it and ``torch._int_mm``; then the
host's enqueue time per call. Last, a sweep over K at M = 8192, N = 2048
(fc1's M and N) splits the GEMM kernel's time into a part per k tile and a
fixed part per wave of output tiles (fill and epilogue), fitted as
time = fixed x waves + per_k_tile x waves x k_tiles by least squares.

    python scripts/torch_gemm_device_times.py [--iters 20]

Needs the card; prints nvidia-smi's name and power limit first.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_int8_gemm_bench as bench  # noqa: E402

SMS = 132
SWEEP_K = (256, 512, 1024, 2048, 4096)


def device_us(fn, iters: int) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches,
    over ``iters`` calls after a warm-up: the kernel's mean over the
    launches the trace recorded, times its launches a call. Traces on the
    card's machine come back short of some launches, more often the more
    traces a process has taken, so the launches a call are the recorded
    count over ``iters``, rounded, and at least 1 (exact for a complete
    trace; right for a kernel launched once a call however many records
    are lost). A trace that comes back without kernels is taken again, up
    to three times; then {} (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / e.count
               * max(1, round(e.count / iters))
               for e in prof.key_averages()
               if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0
               and e.key != "Memset (Device)"}
        if out:
            return out
    return {}


def enqueue_us(fn, iters: int) -> float:
    """Host microseconds per call to enqueue ``fn`` (no synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def short(name: str) -> str:
    for key in ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def calls(ops: dict) -> dict:
    a8, b8, abf, bbf = ops["a8"], ops["b8"], ops["abf"], ops["bbf"]
    out = {"K17 bf16": lambda: k17.gemm_bf16_cuda(abf, bbf),
           "K17 int8": lambda: k17.gemm_int8_cuda(a8, b8),
           "K18": lambda: k17.dynquant_matmul_cuda(a8, b8, ops["sa"],
                                                   ops["sb"]),
           "torch.matmul bf16": lambda: torch.matmul(abf, bbf)}
    for key, fn in (("torch.mm f32 out", bench.library_mm_f32(abf, bbf)),
                    ("torch._int_mm", bench.library_int_mm(a8, b8))):
        if fn is not None:
            out[key] = fn
    return out


def sweep(dtype: torch.dtype, iters: int) -> str:
    """The K sweep of one dtype's K17 at M = 8192, N = 2048."""
    m, n = 8192, 2048
    bk = 128 if dtype == torch.int8 else 64
    waves = math.ceil(math.ceil(m / 128) * math.ceil(n / 128) / SMS)
    xs, ys = [], []
    for k in SWEEP_K:
        ops = bench.operands(m, k, n, "cuda")
        a, b = ((ops["a8"], ops["b8"]) if dtype == torch.int8
                else (ops["abf"], ops["bbf"]))
        times = device_us(lambda: k17.blocked_matmul(a, b), iters)
        if not times:
            return f"sweep {dtype}: not measured (no kernels traced at K {k})"
        xs.append(k // bk)
        ys.append(sum(t for key, t in times.items()
                      if "gemm_kernel" in key))
    per_tile, fixed = np.polyfit(xs, ys, 1)
    peak = 1979e12 if dtype == torch.int8 else 989e12
    ideal = 2 * 128 * 128 * bk / (peak / SMS) * 1e6
    return (f"sweep {str(dtype).replace('torch.', '')} M {m} N {n} "
            f"({waves} waves of 128 x 128 tiles): gemm_kernel us at K "
            + ", ".join(f"{k} {y:.1f}" for k, y in zip(SWEEP_K, ys))
            + f"; fit: {per_tile / waves:.3f} us per k tile per wave (a "
            f"tile's k tile at the peak rate: {ideal:.3f} us), "
            f"{fixed / waves:.2f} us fixed per wave")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gemm_device_times: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for name, m, k, n in bench.SHAPES:
        ops = bench.operands(m, k, n, "cuda")
        for what, fn in calls(ops).items():
            dev = device_us(fn, args.iters)
            total = sum(dev.values())
            times = ("device not measured (no kernels traced)" if not dev
                     else f"device {total:.1f} us ("
                     + ", ".join(f"{short(key)} {t:.1f}"
                                 for key, t in dev.items())
                     + f"), {2 * m * k * n / total / 1e6:.1f} T/s")
            print(f"{name} {what}: {times}; enqueue "
                  f"{enqueue_us(fn, 4 * args.iters):.1f} us a call",
                  flush=True)
    for dtype in (torch.bfloat16, torch.int8):
        print(sweep(dtype, args.iters), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
