"""Time variants of the f32 FFMA GEMM tile against cuBLAS's f32 SGEMM.

Builds ``scripts/torch_ffma_tile_sweep.cu`` (its two parts in parallel,
for sm_90a) into ``build/ffma_tile_sweep/`` and times each variant of its
table (threads, block and thread tiles, slice depth, staging, slices in
flight, launch bounds; the .cu says how each is read) at the flagship's
GEMM shapes at batch 8 (M = 8008: fc1 N 2048 K 1024, fc2 N 1024 K 2048,
the QKV N 1536 K 1024, the out-projection N 1024 K 512) and at fc1 at
batch 32 (M = 32032), with a store epilogue; at fc1 at batch 8 also with
K4's fc1 epilogue in serving (bias and GELU) and in training (also h and
the dropout mask at rate 0.1). Beside each shape, ``torch.mm`` at f32 with
TF32 off. Each variant's output is first held to ``torch.mm``'s within
1e-4 (1 + |mm|) (h at the training epilogue). Times are medians of 20
CUDA-event timings after 3 warm-up launches; ``--rounds`` repeats the
whole sweep and the medians over the rounds are printed, each variant's
with its ratio to ``torch.mm`` of the same round. Also printed: the card's
name and power limit, and each variant's registers and spill bytes from
ptxas.

    python scripts/torch_ffma_tile_sweep.py [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from neurovit_tpu_torch.ops import _build  # noqa: E402

SOURCE = os.path.join(HERE, "scripts", "torch_ffma_tile_sweep.cu")
OUT = os.path.join(HERE, "build", "ffma_tile_sweep")
FIELDS = ("threads", "bn", "tm", "tn", "ly", "bk", "load", "stages",
          "minb")
SHAPES = (("fc1", 8008, 2048, 1024), ("fc2", 8008, 1024, 2048),
          ("qkv", 8008, 1536, 1024), ("outproj", 8008, 1024, 512),
          ("fc1 batch 32", 32032, 2048, 1024))
# Epilogues: 0 stores C; 1 K4's fc1 in training (b1, h, GELU, mask at
# keep_q 230 of 256, rate 0.1); 2 in serving (b1, GELU).
EPILOGUES = {0: "store", 1: "GELU, h, mask", 2: "GELU"}
TOL = 1e-4


def build() -> list:
    """Compile both parts; their libraries and ptxas's (variant, epilogue,
    registers, spill stores, spill loads) lines."""
    nvcc = _build.find_nvcc()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for part in (0, 1):
        lib = os.path.join(OUT, f"part{part}.so")
        procs.append((lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v",
             f"-DPART={part}", SOURCE, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, report = [], []
    for lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{out}")
        libs.append(ctypes.CDLL(lib))
        name, spill = None, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and name and "gemm" in name:
                params = tuple(int(v) for v in re.findall(r"Li(\d+)E", name))
                report.append((params, "GeluEpi" in name, int(m.group(1)),
                               *map(int, spill)))
                name = None
    return libs, report


def variants(libs) -> list:
    """(library, index, parameters) of every variant of both parts."""
    out = []
    for lib in libs:
        lib.exp_gemm.restype = ctypes.c_int
        lib.exp_gemm.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                                 + [ctypes.c_int] * 4)
        desc = (ctypes.c_int * len(FIELDS))()
        for i in range(lib.exp_count()):
            lib.exp_desc(i, desc)
            out.append((lib, i, tuple(desc)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, report = build()
    table = variants(libs)
    print(f"card: {cs.card_line()}; {args.rounds} rounds; variants as "
          f"({', '.join(FIELDS)})")
    for params, gelu, regs, stores, loads in report:
        print(f"ptxas {params} {'GeluEpi' if gelu else 'StoreEpi'}: {regs} "
              f"registers, spill stores {stores} B, loads {loads} B")
    rng = np.random.default_rng(cs.SEED)
    times: dict = {}
    for _ in range(args.rounds):
        for name, m, n, k in SHAPES:
            a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                             device="cuda")
            b = torch.tensor(rng.uniform(-1, 1, (n, k)) / k ** 0.5,
                             dtype=torch.float32, device="cuda")
            b1 = torch.tensor(0.03 * rng.standard_normal(n),
                              dtype=torch.float32, device="cuda")
            want = torch.mm(a, b.t())
            c, h = torch.empty_like(want), torch.empty_like(want)
            mm = cs.cuda_ms(lambda: torch.mm(a, b.t()), runs=20)
            times.setdefault((name, "mm"), []).append((mm, 1.0))
            for epi in (EPILOGUES if name == "fc1" else (0,)):
                for lib, i, params in table:
                    call = (i, epi, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            b1.data_ptr(), h.data_ptr() if epi == 1 else 0,
                            m, n, k, 230 if epi == 1 else 0)
                    if lib.exp_gemm(*call):
                        raise RuntimeError(f"variant {params} did not launch")
                    torch.cuda.synchronize()
                    got = c if epi == 0 else (h if epi == 1 else None)
                    if got is not None:
                        ref = want if epi == 0 else want + b1
                        err = float(((got - ref).abs()
                                     / (1 + ref.abs())).max())
                        if err > TOL:
                            raise AssertionError(f"variant {params} at {name}"
                                                 f": error {err:.3e}")
                    ms = cs.cuda_ms(lambda: lib.exp_gemm(*call), runs=20)
                    times.setdefault((name, epi, params), []).append(
                        (ms, ms / mm))
            del a, b, b1, want, c, h
            torch.cuda.empty_cache()
    for name, m, n, k in SHAPES:
        flop = 2 * m * n * k
        mm = float(np.median([t for t, _ in times[(name, "mm")]]))
        print(f"{name} (M {m}, N {n}, K {k}): torch.mm {mm:.4f} ms, "
              f"{flop / mm / 1e9:.1f} TFLOP/s")
        for epi in (EPILOGUES if name == "fc1" else (0,)):
            for _, _, params in table:
                runs = times[(name, epi, params)]
                ms = float(np.median([t for t, _ in runs]))
                ratio = float(np.median([r for _, r in runs]))
                print(f"  {EPILOGUES[epi]:14s} {params}: {ms:.4f} ms, "
                      f"{flop / ms / 1e9:.1f} TFLOP/s, {ratio:.3f}x torch.mm",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
