"""Device-only times of K12, the int8 residual MLP, pass by pass, beside
K17 int8 at its two GEMM shapes.

``chip_smoke.py`` times a K12 call with CUDA events around it, which also
counts the wrapper's enqueue (four tensor maps, four launches). This script
reads the device's own kernel times from ``torch.profiler``: for the
flagship block (dim 1024, MLP 2048) at batch 1, 8 and 32 x 1001 tokens,
each of K12's four passes (LN row quantizer, fc1 + GELU, g's row
quantizer, fc2 + residual), their sum and the host's enqueue time per
call; then, as the yardstick of the two GEMM passes, K17 int8's GEMM
kernel (and its transpose step, apart) at [M, dim] x [dim, hid] and [M,
hid] x [hid, dim], M the batch-8 rows rounded up to 16, which K17 needs.

    python scripts/torch_int8_mlp_device_times.py [--iters 20]

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

from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gemm_device_times as gemm_times  # noqa: E402

N, DIM, HID = 1001, 1024, 2048
PASSES = ("ln_rowquant", "fc1_gelu", "g_rowquant", "fc2_residual")


def operands(b: int, dim: int = DIM, hid: int = HID, seed: int = 42
             ) -> tuple:
    """K12's operands for x [b, N, dim], made as chip_smoke.py's kernel
    phase makes them: standard normal x, LN affines near (1, 0), int8
    weights quantized from nn.Linear's default range, small biases."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    def w(out_f, in_f):
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    return (t(b, N, dim), t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim, scale=0.1, dtype=torch.float32),
            *q8.quantize_weight(w(hid, dim)),
            t(hid, scale=0.03, dtype=torch.float32),
            *q8.quantize_weight(w(dim, hid)),
            t(dim, scale=0.02, dtype=torch.float32))


def short(name: str) -> str:
    if "rowquant_kernel<true>" in name:   # the row pass's LayerNorm instance
        return "ln_rowquant"
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int) -> dict:
    """Device microseconds of each pass of one K12 call on ``args``, their
    sum in ms ({} and None where the trace held no kernels), and the
    host's enqueue microseconds a call."""
    dev = gemm_times.device_us(lambda: q8.int8_mlp_block_cuda(*args), iters)
    passes = {}
    for key, us in dev.items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "enqueue_us": gemm_times.enqueue_us(
                lambda: q8.int8_mlp_block_cuda(*args), 4 * iters)}


def yardstick(m: int, dim: int, hid: int, iters: int) -> dict:
    """K17 int8 at fc1's [m, dim] x [dim, hid] and fc2's [m, hid] x [hid,
    dim] (m rounded up to 16): {shape: {kernel: device us}}."""
    m16 = -(-m // 16) * 16
    rng = np.random.default_rng(0)
    out = {}
    for name, k, n in (("fc1", dim, hid), ("fc2", hid, dim)):
        a = torch.tensor(rng.integers(-127, 128, (m16, k)), dtype=torch.int8,
                         device="cuda")
        b = torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8,
                         device="cuda")
        dev = gemm_times.device_us(lambda: k17.gemm_int8_cuda(a, b), iters)
        out[f"{name} [{m16}, {k}] x [{k}, {n}]"] = {
            short(key): us for key, us in dev.items()}
    return out


def line(what: str, m: dict) -> str:
    if not m["passes_us"]:
        return f"{what}: device not measured (no kernels traced)"
    parts = ", ".join(f"{p} {m['passes_us'].get(p, 0.0):.1f}"
                      for p in PASSES)
    return (f"{what}: device {m['device_ms']:.4f} ms ({parts} us); enqueue "
            f"{m['enqueue_us']:.1f} us a call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_mlp_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for b in (1, 8, 32):
        ops = operands(b)
        print(line(f"K12 batch {b} (M {b * N}, dim {DIM}, mlp {HID})",
                   measure(ops, args.iters)), flush=True)
        del ops
    for shape, dev in yardstick(8 * N, DIM, HID, args.iters).items():
        print(f"K17 int8 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
