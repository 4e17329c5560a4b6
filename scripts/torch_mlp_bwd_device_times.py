"""Device-only times of K9, the bf16 residual MLP's data-grad backward,
pass by pass, beside K17 bf16 at its two GEMM shapes.

``chip_smoke.py`` times a K9 call with CUDA events around it, which also
counts the wrapper's enqueue (six tensor maps, five launches). This script
reads the device's own kernel times from ``torch.profiler``: for the
flagship block (dim 1024, MLP 2048) at batch 1, 8, 32 and 128 (the train
step's) x 1001 tokens, each of K9's five passes (dz rows, the hidden GEMM,
the du GEMM, the LayerNorm backward rows, the column sums), their sum and
the host's enqueue time per call, as the train step calls it (dropout 0.1)
and as Grad-CAM does (dropout 0); then, as the yardstick of the two GEMM passes, K17 bf16's
GEMM kernel (and its transpose step, apart) at da's [M, dim] x [dim, hid]
and du's [M, hid] x [hid, dim], M the batch-8 rows rounded up to 16,
which K17 needs.

    python scripts/torch_mlp_bwd_device_times.py [--iters 20]

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

from neurovit_tpu_torch.ops import fused_mlp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gemm_device_times as gemm_times  # noqa: E402
import torch_mlp_device_times as k4_times  # noqa: E402

N, DIM, HID = k4_times.N, k4_times.DIM, k4_times.HID
PASSES = ("dz_rows", "hidden", "du_kernel", "ln_bwd", "colsum")
TRAIN = {"dropout_rate": 0.1, "seeds": (1235, 1236)}


def operands(b: int, dim: int = DIM, hid: int = HID, seed: int = 42
             ) -> tuple:
    """K9's operands for x [b, N, dim]: (dy, x, h, gamma, beta, w1, w2),
    made as chip_smoke.py's kernel phase makes them (K4's operands, h from
    K4's own forward at dropout 0.1, dy standard normal times 0.1)."""
    x, gamma, beta, w1, b1, w2, b2 = k4_times.operands(b, dim, hid, seed)
    _, h = fused_mlp.fused_mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2,
                                          **k4_times.TRAIN)
    rng = np.random.default_rng(seed + 1)
    dy = torch.tensor(0.1 * rng.standard_normal(tuple(x.shape)),
                      dtype=torch.bfloat16, device="cuda")
    return dy, x, h, gamma, beta, w1, w2


def short(name: str) -> str:
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int, **kw) -> dict:
    """Device microseconds of each pass of one K9 call on ``args`` (with
    the keywords ``kw``), their sum in ms ({} and None where the trace held
    no kernels), and the host's enqueue microseconds a call."""
    call = lambda: fused_mlp.fused_mlp_bwd_cuda(*args, **kw)  # noqa: E731
    dev = gemm_times.device_us(call, iters)
    passes = {}
    for key, us in dev.items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "enqueue_us": gemm_times.enqueue_us(call, 4 * iters)}


def yardstick(m: int, dim: int, hid: int, iters: int) -> dict:
    """K17 bf16 at the hidden GEMM's [m, dim] x [dim, hid] and the du
    GEMM's [m, hid] x [hid, dim]: {shape: {kernel: device us}}."""
    return {key.replace("fc1", "da").replace("fc2", "du"): dev
            for key, dev in k4_times.yardstick(m, dim, hid, iters).items()}


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
        print("torch_mlp_bwd_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for b in (1, 8, 32, 128):
        ops = operands(b)
        what = f"K9 batch {b} (M {b * N}, dim {DIM}, mlp {HID})"
        print(line(what + " dropout 0.1", measure(ops, args.iters, **TRAIN)),
              flush=True)
        print(line(what + " dropout 0", measure(ops, args.iters)), flush=True)
        del ops
    for shape, dev in yardstick(8 * N, DIM, HID, args.iters).items():
        print(f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
