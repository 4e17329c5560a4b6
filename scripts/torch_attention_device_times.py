"""Device-only times of the attention forward (K1, K6) beside SDPA.

``chip_smoke.py`` times one call with CUDA events around it, which for a
call near 0.1 ms also counts the host's enqueue. This script reads the
device's own kernel times from ``torch.profiler`` (``device_us`` of
``scripts/torch_gemm_device_times.py``): K1 ([B, N, H, D]) at batch 1, 8,
32 and 128 (128 is the train step's batch), at dropout 0 and 0.1, and K6
([B, H, N, D]) at batch 1 and 8 (the Grad-CAM shapes) at dropout 0, each
at 1001 tokens and 8 heads of 64 and of 128, beside
``F.scaled_dot_product_attention`` on the same tensors (a yardstick only,
never called by the port; it has neither the +-96 exp2 clamp nor the
``n_valid`` mask nor the Philox mask). Each line gives the rate in TFLOP/s
(4 B H N^2 D per call), the bound (operations / 989 TFLOP/s; the bytes
take far less), the exp2 floor (B H N n_valid exponentials on 16 MUFU
lanes a clock on each of 132 SMs at 1.98 GHz) and the host's enqueue time
per call.

    python scripts/torch_attention_device_times.py [--iters 20]

Needs the card; prints nvidia-smi's name and power limit first.
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

from neurovit_tpu_torch.ops import flash_attention as fa  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

N, HEADS = 1001, 8
PEAK_BF16 = 989e12
EXP2_PER_S = 132 * 16 * 1.98e9
# (kernel, layout, batches, dropout rates)
CASES = (("K1", "bnhd", (1, 8, 32, 128), (0.0, 0.1)),
         ("K6", "bhnd", (1, 8), (0.0,)))


def operands(b: int, d: int, layout: str, seed: int = 0) -> list:
    """Seeded bf16 q, k, v in ``layout``, on the card."""
    rng = np.random.default_rng(seed)
    shape = (b, N, HEADS, d) if layout == "bnhd" else (b, HEADS, N, d)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                         device="cuda") for _ in range(3)]


def exp2_floor_ms(b: int, n_valid: int = N) -> float:
    return b * HEADS * N * n_valid / EXP2_PER_S * 1e3


def kernel_call(qkv: list, layout: str, rate: float):
    fn = (fa.flash_attention_cuda if layout == "bnhd"
          else fa.flash_attention_bhnd_cuda)
    d = qkv[0].shape[-1]
    return lambda: fn(*qkv, scale=d ** -0.5, n_valid=N, dropout_rate=rate,
                      seed=1234, return_stats=bool(rate))


def sdpa_call(qkv: list, layout: str):
    d = qkv[0].shape[-1]
    heads_first = ([t.transpose(1, 2) for t in qkv] if layout == "bnhd"
                   else qkv)
    return lambda: F.scaled_dot_product_attention(*heads_first,
                                                  scale=d ** -0.5)


def measure(qkv: list, layout: str, rate: float, iters: int) -> dict:
    """Device ms of the kernel and of SDPA on ``qkv``, the kernel's enqueue
    µs per call; a device time is None where the trace held no kernel."""
    kernel, lib = kernel_call(qkv, layout, rate), sdpa_call(qkv, layout)
    dev, lib_dev = device_us(kernel, iters), device_us(lib, iters)
    return {"device_ms": sum(dev.values()) / 1e3 if dev else None,
            "library_device_ms": (sum(lib_dev.values()) / 1e3 if lib_dev
                                  else None),
            "enqueue_us": enqueue_us(kernel, 4 * iters),
            "library_enqueue_us": enqueue_us(lib, 4 * iters)}


def line(name: str, b: int, d: int, rate: float, m: dict) -> str:
    flop = 4 * b * HEADS * N * N * d
    bound_ms = flop / PEAK_BF16 * 1e3

    def ms(t):
        return ("not measured" if t is None
                else f"{t:.4f} ms ({flop / t / 1e9:.1f} TFLOP/s)")

    return (f"{name} B {b} N {N} H {HEADS} D {d} dropout {rate}: device "
            f"{ms(m['device_ms'])}, SDPA device {ms(m['library_device_ms'])}; "
            f"bound {bound_ms:.4f} ms, exp2 floor {exp2_floor_ms(b):.4f} ms; "
            f"enqueue {m['enqueue_us']:.1f} us a call (SDPA "
            f"{m['library_enqueue_us']:.1f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for name, layout, batches, rates in CASES:
        for d in (64, 128):
            for b in batches:
                qkv = operands(b, d, layout)
                for rate in rates:
                    print(line(name, b, d, rate,
                               measure(qkv, layout, rate, args.iters)),
                          flush=True)
                del qkv
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
