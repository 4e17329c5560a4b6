"""The card's rate of mma.sync's TF32 MMA (m16n8k8), the instruction the
f32 attention backward (csrc/flash_attention_bwd_f32.cu on
csrc/tf32x3.cuh) runs its 3xTF32 products on: the ceiling that design can
reach, beside the 495 TF32 TFLOP/s of the data sheet, which only wgmma
reaches.

Builds ``scripts/torch_mma_tf32_peak.cu`` (for sm_90a) into
``build/mma_tf32_peak/`` and launches 4 blocks an SM of 128, 256 and 512
threads, each warp issuing 4, 8 or 16 independent MMAs a loop step, 4000
steps; prints each launch's TF32 TFLOP/s (2048 flops an MMA over one
CUDA-event timing after a warm-up launch), the best, and what it gives
for f32 products in 3xTF32 (a third), with the card's name and power
limit.

    python scripts/torch_mma_tf32_peak.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from neurovit_tpu_torch.ops import _build  # noqa: E402

SOURCE = os.path.join(HERE, "scripts", "torch_mma_tf32_peak.cu")
OUT = os.path.join(HERE, "build", "mma_tf32_peak")
SMS, ITERS, FLOPS_PER_MMA = 132, 4000, 2 * 16 * 8 * 8


def build() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libmma_tf32_peak.so")
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", lib, SOURCE],
                   check=True)
    out = ctypes.CDLL(lib)
    out.nvt_mma_tf32_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    out.nvt_mma_tf32_loop.restype = ctypes.c_int
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_tf32_peak: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    lib = build()
    best = 0.0
    for threads in (128, 256, 512):
        for chains in (4, 8, 16):
            blocks = 4 * SMS
            out = torch.empty(blocks * threads, device="cuda")
            run = lambda iters: lib.nvt_mma_tf32_loop(  # noqa: E731
                out.data_ptr(), blocks, threads, iters, chains)
            if run(100):
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(ITERS)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            mmas = blocks * threads // 32 * ITERS * chains
            tflops = mmas * FLOPS_PER_MMA / ms / 1e9
            best = max(best, tflops)
            print(f"{threads} threads a block, {chains} chains a warp: "
                  f"{tflops:.1f} TF32 TFLOP/s ({ms:.3f} ms)", flush=True)
    print(f"best {best:.1f} TF32 TFLOP/s ({best / 495:.3f} of 495); f32 "
          f"products in 3xTF32 at most {best / 3:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
