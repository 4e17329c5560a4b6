"""Device-only times of K13, the int8 attention, launch by launch, beside
K1's at the same shapes.

``chip_smoke.py`` times a K13 call with CUDA events around it, which also
counts the wrapper's enqueue (four tensor maps, three launches). This script
reads the device's own kernel times from ``torch.profiler`` (``device_us``
of ``scripts/torch_gemm_device_times.py``): K13 on [B, 1001, 8, D] at
batch 1, 8 and 32, n_valid 1001 and 900, D 64 and 128, split into its V
prologue (``v_amax``, ``v_quant``) and the attention kernel, beside K1 (the
bf16 attention K13 stands in for) on the same q, k, v. Each line gives
K13's bound (its function's work: one bf16 QK^T at 989 TFLOP/s and one s8
P V at 1,979 TOP/s over the n_valid keys, or its bytes at 3.35 TB/s, the
larger), its two-sweep floor (QK^T twice, as the kernel computes it), the
exp2 floor (B H N n_valid exponentials on 16 MUFU lanes a clock on each of
132 SMs at 1.98 GHz), the median one-call CUDA-event time and the host's
enqueue time per call.

    python scripts/torch_int8_attention_device_times.py [--iters 20]

Needs the card; prints nvidia-smi's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attention_device_times import events_ms  # noqa: E402
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

N, HEADS = 1001, 8
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
EXP2_PER_S = 132 * 16 * 1.98e9
PASSES = ("v_amax", "v_quant", "int8_attn")


def operands(b: int, d: int, seed: int = 0) -> list:
    """Seeded bf16 q, k, v [b, N, 8, d] on the card."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((b, N, HEADS, d)),
                         dtype=torch.bfloat16, device="cuda")
            for _ in range(3)]


def floors(b: int, d: int, n_valid: int) -> dict:
    """K13's bound and by what, its two-sweep floor and the exp2 floor, in
    ms, for q, k, v [b, N, 8, d] at n_valid."""
    products = 2 * b * HEADS * N * n_valid * d       # one QK^T or one P V
    t_ops = products / PEAK_BF16 + products / PEAK_INT8
    t_bytes = 4 * b * N * HEADS * d * 2 / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "two_sweep_ms": (2 * products / PEAK_BF16
                             + products / PEAK_INT8) * 1e3,
            "exp2_ms": b * HEADS * N * n_valid / EXP2_PER_S * 1e3}


def short(name: str) -> str:
    for key in PASSES:
        if key in name:
            return key
    return name[:48]


def measure(qkv: list, n_valid: int, iters: int) -> dict:
    """K13's device microseconds per launch on ``qkv`` at ``n_valid``, their
    sum in ms (None where the trace held no kernels), K1's device ms on the
    same operands, K13's one-call event ms and enqueue microseconds."""
    d = qkv[0].shape[-1]
    kw = {"scale": d ** -0.5, "n_valid": n_valid}

    def k13():
        return q8.int8_flash_attention_cuda(*qkv, **kw)

    def k1():
        return fa.flash_attention_cuda(*qkv, **kw)

    passes = {}
    for key, us in device_us(k13, iters).items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    k1_dev = device_us(k1, iters)
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "k1_device_ms": sum(k1_dev.values()) / 1e3 if k1_dev else None,
            "ms": events_ms(k13), "k1_ms": events_ms(k1),
            "enqueue_us": enqueue_us(k13, 4 * iters)}


def line(what: str, b: int, d: int, n_valid: int, m: dict) -> str:
    f = floors(b, d, n_valid)

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    parts = ", ".join(f"{p} {m['passes_us'].get(p, 0.0):.1f}"
                      for p in PASSES)
    return (f"{what} B {b} N {N} H {HEADS} D {d} n_valid {n_valid}: device "
            f"{ms(m['device_ms'])} ({parts} us), events {m['ms']:.4f} ms; "
            f"K1 device {ms(m['k1_device_ms'])}, events {m['k1_ms']:.4f} ms; "
            f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}), two-sweep "
            f"floor {f['two_sweep_ms']:.4f} ms, exp2 floor "
            f"{f['exp2_ms']:.4f} ms; enqueue {m['enqueue_us']:.1f} us a call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_attention_device_times: needs the card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for d in (64, 128):
        for b in (1, 8, 32):
            qkv = operands(b, d)
            for n_valid in (N, 900):
                print(line("K13", b, d, n_valid,
                           measure(qkv, n_valid, args.iters)), flush=True)
            del qkv
    return 0


if __name__ == "__main__":
    sys.exit(main())
