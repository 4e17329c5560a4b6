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

K13 at f32 (``--only f32``): the same passes of
``int8_flash_attention_f32_cuda`` on f32 q, k, v [B, 1001, 8, D] at batch 8
and 32 (D 64, n_valid 1001 and 900) and at batch 8 with D 128, beside K1 at
f32 on the same operands. Its bound counts one f32 QK^T at the 3xTF32
rate (165 TFLOP/s) and one s8 P V at 1,979 TOP/s over the n_valid keys
(or the f32 bytes, the larger); the design floor counts its two sweeps of
QK^T at ``mma.sync``'s 3xTF32 rate (107 TFLOP/s, a third of the 322 TF32
TFLOP/s of ``scripts/torch_mma_tf32_peak.py``) plus the s8 P V; the FFMA
floor the same two sweeps on the CUDA cores (67 TFLOP/s). ``--other
<checkout>`` routes every kernel call to another checkout's kernel library
(built there), so the parent's kernels are timed with the same cases.

    python scripts/torch_int8_attention_device_times.py [--iters 20]
        [--only bf16|f32] [--other <checkout>]

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
from torch_attention_device_times import (events_ms,  # noqa: E402
                                          use_checkout)
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

N, HEADS = 1001, 8
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
EXP2_PER_S = 132 * 16 * 1.98e9
PASSES = ("v_amax", "v_quant", "int8_attn")
TF32X3_PER_S, MMA_SYNC_3X_PER_S, FFMA_PER_S = 165e12, 107e12, 67e12
# (batch, head dim) of the f32 cases, each at n_valid N and 900.
F32_CASES = ((8, 64), (32, 64), (8, 128))


def operands(b: int, d: int, seed: int = 0,
             dtype=torch.bfloat16) -> list:
    """Seeded q, k, v [b, N, 8, d] of ``dtype`` on the card."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((b, N, HEADS, d)), dtype=dtype,
                         device="cuda")
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


def f32_floors(b: int, d: int, n_valid: int) -> dict:
    """K13 f32's bound and by what, its design floor (two 3xTF32 sweeps of
    QK^T on mma.sync plus the s8 P V) and the FFMA floor of the two
    sweeps, in ms, for f32 q, k, v [b, N, 8, d] at n_valid."""
    products = 2 * b * HEADS * N * n_valid * d
    t_ops = products / TF32X3_PER_S + products / PEAK_INT8
    t_bytes = 4 * b * N * HEADS * d * 4 / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "floor_ms": (2 * products / MMA_SYNC_3X_PER_S
                         + products / PEAK_INT8) * 1e3,
            "ffma_ms": 2 * products / FFMA_PER_S * 1e3}


def short(name: str) -> str:
    for key in PASSES:
        if key in name:
            return key
    return name[:48]


def measure(qkv: list, n_valid: int, iters: int) -> dict:
    """K13's device microseconds per launch on ``qkv`` at ``n_valid``, their
    sum in ms (None where the trace held no kernels), K1's device ms on the
    same operands, K13's one-call event ms and enqueue microseconds; the
    f32 instances of both on f32 operands."""
    d = qkv[0].shape[-1]
    kw = {"scale": d ** -0.5, "n_valid": n_valid}
    f32 = qkv[0].dtype == torch.float32
    k13_fn = (q8.int8_flash_attention_f32_cuda if f32
              else q8.int8_flash_attention_cuda)
    k1_fn = fa.flash_attention_f32_cuda if f32 else fa.flash_attention_cuda

    def k13():
        return k13_fn(*qkv, **kw)

    def k1():
        return k1_fn(*qkv, **kw)

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


def f32_line(b: int, d: int, n_valid: int, m: dict) -> str:
    f = f32_floors(b, d, n_valid)

    def ms(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    parts = ", ".join(f"{p} {m['passes_us'].get(p, 0.0):.1f}"
                      for p in PASSES)
    attn = m["passes_us"].get("int8_attn")
    rate = ("not measured" if not attn else
            f"{2 * 2 * b * HEADS * N * n_valid * d / attn / 1e6:.1f} TFLOP/s "
            f"of the two sweeps' QK^T")
    return (f"K13 f32 B {b} N {N} H {HEADS} D {d} n_valid {n_valid}: device "
            f"{ms(m['device_ms'])} ({parts} us; {rate}), events "
            f"{m['ms']:.4f} ms; K1 f32 device {ms(m['k1_device_ms'])}, events "
            f"{m['k1_ms']:.4f} ms; bound {f['bound_ms']:.4f} ms "
            f"({f['bound_by']}), design floor {f['floor_ms']:.4f} ms, FFMA "
            f"floor {f['ffma_ms']:.4f} ms; enqueue {m['enqueue_us']:.1f} us "
            f"a call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default="bf16",
                    help="time K13 (bf16, the default) or K13 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_attention_device_times: needs the card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.other:
        use_checkout(os.path.abspath(args.other))
        print(f"kernels of {args.other}")
    if args.only == "f32":
        for b, d in F32_CASES:
            qkv = operands(b, d, dtype=torch.float32)
            for n_valid in (N, 900):
                print(f32_line(b, d, n_valid,
                               measure(qkv, n_valid, args.iters)), flush=True)
            del qkv
            torch.cuda.empty_cache()
        return 0
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
