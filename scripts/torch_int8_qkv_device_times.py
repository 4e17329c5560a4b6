"""Device-only times of K10, the int8 LN + QKV, pass by pass, beside K17
int8 and ``torch._int_mm`` at its GEMM's shape.

``chip_smoke.py`` times a K10 call with CUDA events around it, which also
counts the wrapper's enqueue (two tensor maps, two launches). This script
reads the device's own kernel times from ``torch.profiler`` (``device_us``
of ``scripts/torch_gemm_device_times.py``): K10 on x [B, 1001, dim] at
batch 1, 8 and 32 of the flagship (dim 1024, 8 heads of 64) and at ViT-H
(dim 1280, 16 heads of 80) at batch 8, split into its LN row quantizer
(``ln_rowquant``) and its GEMM (``qkv_gemm``); an older checkout's single
``wmma`` kernel shows as ``int8_qkv_kernel``. Each line gives K10's bound
(6 M dim inner int8 operations at 1,979 TOP/s, or its bytes at 3.35 TB/s,
the larger), the design's bytes floor (x read, the codes written and read
again, q, k and v written, W8 read), the median one-call CUDA-event time
and the host's enqueue time per call. Then, at each of those shapes, the
yardsticks of the GEMM pass: K17 int8's GEMM kernel (its transpose step
apart) and ``torch._int_mm`` at [M rounded up to 16, dim] x [dim, 3
inner].

    python scripts/torch_int8_qkv_device_times.py [--iters 20]

Needs the card; prints nvidia-smi's name and power limit first. Copied
into an older checkout's ``scripts/``, it times that checkout's K10.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attention_device_times import events_ms  # noqa: E402
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

N = 1001
PEAK_INT8, HBM_BYTES_PER_S = 1979e12, 3.35e12
# name -> (dim, heads, dim_head)
SHAPES = {"flagship": (1024, 8, 64), "vit_h": (1280, 16, 80)}
CASES = (("flagship", 1), ("flagship", 8), ("flagship", 32), ("vit_h", 8))
PASSES = ("ln_rowquant", "qkv_gemm", "int8_qkv_kernel")


def operands(b: int, dim: int = 1024, heads: int = 8, dh: int = 64,
             seed: int = 42) -> tuple:
    """K10's operands for x [b, N, dim], made as chip_smoke.py's kernel
    phase makes them: standard normal x, LN affines near (1, 0), the int8
    weight quantized from nn.Linear's default range."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    w = rng.uniform(-1, 1, (3 * heads * dh, dim)) / dim ** 0.5
    return (t(b, N, dim), t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim, scale=0.1, dtype=torch.float32),
            *q8.quantize_weight(torch.tensor(w, dtype=torch.float32,
                                             device="cuda")), heads, dh)


def floors(m: int, dim: int, inner: int) -> dict:
    """K10's bound and by what, and the design's bytes floor, in ms, for
    m rows."""
    t_ops = 6 * m * dim * inner / PEAK_INT8
    t_bytes = (2 * m * dim + 8 * dim + 3 * inner * dim + 12 * inner
               + 6 * m * inner) / HBM_BYTES_PER_S
    design = (2 * m * dim + 2 * m * dim + 6 * m * inner + 3 * inner * dim
              ) / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "design_ms": design * 1e3}


def short(name: str) -> str:
    if "rowquant_kernel<true>" in name:   # the row pass's LayerNorm instance
        return "ln_rowquant"
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int) -> dict:
    """Device microseconds of each pass of one K10 call on ``args``, their
    sum in ms ({} and None where the trace held no kernels), the median
    one-call CUDA-event ms, and the host's enqueue microseconds a call."""
    def call():
        return q8.int8_ln_qkv_cuda(*args)

    passes = {}
    for key, us in device_us(call, iters).items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "events_ms": events_ms(call),
            "enqueue_us": enqueue_us(call, 4 * iters)}


def yardstick(m: int, dim: int, inner: int, iters: int) -> dict:
    """K17 int8 and ``torch._int_mm`` at [m16, dim] x [dim, 3 inner], m16
    = m rounded up to 16: {call: {kernel: device us}}."""
    m16 = -(-m // 16) * 16
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.integers(-127, 128, (m16, dim)), dtype=torch.int8,
                     device="cuda")
    b = torch.tensor(rng.integers(-127, 128, (dim, 3 * inner)),
                     dtype=torch.int8, device="cuda")
    out = {}
    for name, fn in (("K17 int8", lambda: k17.gemm_int8_cuda(a, b)),
                     ("torch._int_mm", lambda: torch._int_mm(a, b))):
        dev = device_us(fn, iters)
        out[f"{name} [{m16}, {dim}] x [{dim}, {3 * inner}]"] = {
            short(key): us for key, us in dev.items()}
    return out


def line(what: str, m: dict, f: dict) -> str:
    if not m["passes_us"]:
        head = f"{what}: device not measured (no kernels traced)"
    else:
        parts = ", ".join(f"{p} {us:.1f}" for p, us in m["passes_us"].items())
        head = f"{what}: device {m['device_ms']:.4f} ms ({parts} us)"
    return (f"{head}; events {m['events_ms']:.4f} ms; bound "
            f"{f['bound_ms']:.4f} ms ({f['bound_by']}), design bytes "
            f"{f['design_ms']:.4f} ms; enqueue {m['enqueue_us']:.1f} us a "
            f"call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_qkv_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for name, b in CASES:
        dim, heads, dh = SHAPES[name]
        what = f"K10 {name} batch {b} (M {b * N}, dim {dim}, inner " \
               f"{heads * dh})"
        ops = operands(b, dim, heads, dh)
        try:
            print(line(what, measure(ops, args.iters),
                       floors(b * N, dim, heads * dh)), flush=True)
        except ValueError as err:       # an older checkout's width gate
            print(f"{what}: refused ({err})", flush=True)
        del ops
        for shape, dev in yardstick(b * N, dim, heads * dh,
                                    args.iters).items():
            print(f"  {shape}: " + (", ".join(
                f"{k} {us:.1f} us" for k, us in dev.items()) or
                "device not measured (no kernels traced)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
