"""Variants of K8 at f32 (``csrc/fused_outproj_bwd_f32.cu`` on
``csrc/tf32x3_wgmma.cuh``), each built apart and timed in turns against
the sources as they are, to show what the design's choice of sums and
ring buys:

- ``fresh_2`` and ``fresh_8``: a fresh accumulator every 2 or 8 stages
  (24 or 96 TF32 products deep), where the design takes one a stage (12);
- ``one_accumulator``: every product summed in the tile's accumulator
  over the whole k (384 TF32 products deep at dim 1024; a wgmma rounds its
  sum toward zero), no fresh accumulator and no f32 adds;
- ``ring_3``: three stages of 48 KiB in the ring where the design has
  four.

Each variant is the source with a line replaced (``VARIANTS``;
``tests/test_torch_outproj_bwd_tf32x3.py`` checks that every replaced text
is in it), compiled with ``csrc/ffma.cu`` (the dz rows pass) into
``build/outproj_bwd_f32_variants/<name>/`` (one nvcc each, in parallel,
for sm_90a). At the flagship block (batch 8 and 32 x 1001 tokens, dim 1024,
inner 512), dropout 0 and 0.1: each variant's time in turns (``--rounds``
of this, the variants, then back; each turn the median of 10 CUDA-event
timings of ``fused_outproj_bwd_f32_cuda`` routed to that variant's
library), the profiler's device time of its dattn GEMM, its largest
|got - plain| / (1 + |plain|) and the relative Frobenius error of dattn
against the plain backward on the card; with ptxas's registers and spills,
and the card's name and power limit.

    python scripts/torch_outproj_bwd_f32_variants.py [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from neurovit_tpu_torch.ops import _build  # noqa: E402
from neurovit_tpu_torch.ops import fused_outproj as k3  # noqa: E402

SOURCE = "fused_outproj_bwd_f32.cu"
SOURCES = (SOURCE, "ffma.cu")
OUT = os.path.join(HERE, "build", "outproj_bwd_f32_variants")
FRESH = "constexpr int kFreshStages = 1;"
# name -> [(file, text in it, replacement)]
VARIANTS = {
    "this": [],
    "fresh_2": [(SOURCE, FRESH, "constexpr int kFreshStages = 2;")],
    "fresh_8": [(SOURCE, FRESH, "constexpr int kFreshStages = 8;")],
    "one_accumulator": [(SOURCE, FRESH, "constexpr int kFreshStages = 0;")],
    "ring_3": [(SOURCE, "constexpr int kStages = 4;",
                "constexpr int kStages = 3;")],
}
BATCHES = (8, 32)
N, DIM, INNER = 1001, 1024, 512
TF32X3_PER_S = 165e12


def sources_of(name: str) -> dict:
    """The variant's text of the file it may change."""
    texts = {SOURCE: (_build.CSRC / SOURCE).read_text()}
    for fname, old, new in VARIANTS[name]:
        if old not in texts[fname]:
            raise ValueError(f"variant {name}: text not in {fname}: "
                             f"{old[:60]!r}")
        texts[fname] = texts[fname].replace(old, new, 1)
    return texts


def build(names) -> dict:
    """Compile each variant into its own library; name -> (library path,
    ptxas's {kernel: (registers, spill bytes)} of the K8 source)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name in names:
        tree = os.path.join(OUT, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_build.CSRC, tree)
        for fname, text in sources_of(name).items():
            with open(os.path.join(tree, fname), "w") as f:
                f.write(text)
        lib = os.path.join(tree, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", tree, "-o", lib,
             *(os.path.join(tree, f) for f in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = {}
        for fn, spill, used in re.findall(
                r"Compiling entry function '([^']+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log, re.S):
            m = re.search(r"(dattn_kernel|split_t_kernel)", fn)
            if m:
                regs[m.group(1)] = (int(used), int(spill))
        out[name] = (lib, regs)
    return out


def use(lib: ctypes.CDLL) -> None:
    _build._function.cache_clear()
    _build.library = lambda: lib


def events_ms(fn, runs: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def dattn_ms(fn, iters: int = 10):
    """Device ms a call of the dattn GEMM by the profiler; None where the
    trace held none."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.self_device_time_total / iters / 1e3
             for e in prof.key_averages() if "dattn_kernel" in e.key]
    return times[0] if times else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_outproj_bwd_f32_variants: needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    built = build(VARIANTS)
    libs = {name: ctypes.CDLL(lib) for name, (lib, _) in built.items()}
    for name, (_, regs) in built.items():
        print(f"{name}: ptxas " + ", ".join(
            f"{k} {r} registers, {s} bytes spilled"
            for k, (r, s) in sorted(regs.items())))
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.uniform(-1, 1, (DIM, INNER)) / INNER ** 0.5,
                     dtype=torch.float32, device="cuda")
    for b in BATCHES:
        dy = torch.tensor(0.1 * rng.standard_normal((b, N, DIM)),
                          dtype=torch.float32, device="cuda")
        flop = 2 * b * N * DIM * INNER
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=3)
            want = k3.fused_outproj_bwd_plain(dy, w, **kw)[0]

            def call():
                return k3.fused_outproj_bwd_f32_cuda(dy, w, **kw)
            order = list(libs)
            turns = {name: [] for name in libs}
            for _ in range(args.rounds):
                for name in order + order[::-1]:
                    use(libs[name])
                    turns[name].append(events_ms(call))
            base = float(np.median(turns["this"]))
            for name in libs:
                use(libs[name])
                got = call()[0]
                torch.cuda.synchronize()
                err = float(((got - want).abs() / (1 + want.abs())).max())
                rel = float((got - want).norm() / want.norm())
                ms = float(np.median(turns[name]))
                dev = dattn_ms(call)
                print(f"B {b} N {N} dim {DIM} inner {INNER} dropout {rate} "
                      f"{name}: {ms:.4f} ms ({ms / base:.3f}x this), dattn "
                      + ("not measured" if dev is None else
                         f"device {dev:.4f} ms ({flop / dev / 1e9:.1f} "
                         f"TFLOP/s, {flop / TF32X3_PER_S * 1e3 / dev:.3f} "
                         "of the 3xTF32 bound)")
                      + f", max |err| / (1 + |plain|) {err:.3e}, relative "
                      f"Frobenius {rel:.3e}", flush=True)
        del dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
