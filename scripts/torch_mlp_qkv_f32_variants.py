"""Variants of K4 and K2 at f32 (``csrc/fused_mlp_f32.cu`` and
``csrc/fused_qkv_f32.cu`` on ``csrc/tf32x3_wgmma.cuh``), each built apart
and timed in turns against the sources as they are, to show what the
design's ring, sums and dropout draws buy:

- ``ring_3``: three stages of 48 KiB in the ring where the design has
  four (still one block an SM);
- ``fresh_2``: a fresh accumulator every 2 stages (24 TF32 products
  deep), where the design takes one a stage (12);
- ``one_accumulator``: every product summed in the tile's accumulator
  over the whole k (768 TF32 products deep at fc2's k = 2048; a wgmma
  rounds its sum toward zero), no fresh accumulator and no f32 adds;
- ``philox_pair``: the dropout bytes of a for_each_quad group from one
  Philox call a pair (two a group, the same bits), where the design draws
  one a group (keep_quad).

Each variant is the sources with a line replaced (``VARIANTS``;
``tests/test_torch_mlp_qkv_fwd_tf32x3.py`` checks that every replaced text
is in its file once), compiled with ``csrc/ffma.cu`` (the LayerNorm rows
pass) into ``build/mlp_qkv_f32_variants/<name>/`` (one nvcc each, in
parallel, for sm_90a). At the flagship block (batch 8 and 32 x 1001
tokens, dim 1024, 8 heads of 64, MLP 2048): K4 at dropout 0 and at 0.1
with h, K2 as served; each variant's time in turns (``--rounds`` of this,
the variants, then back; each turn the median of 10 CUDA-event timings of
``fused_mlp_block_f32_cuda`` or ``fused_ln_qkv_f32_cuda`` routed to that
variant's library), the profiler's device time of its GEMMs, its largest
|got - plain| / (1 + |plain|) and the relative Frobenius error of y (K4)
or q (K2) against plain on the card; with ptxas's registers and spills,
and the card's name and power limit.

    python scripts/torch_mlp_qkv_f32_variants.py [--rounds 3]
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

from neurovit_tpu_torch.ops import _build, fused_mlp, fused_qkv  # noqa: E402

MLP, QKV, LOOP = "fused_mlp_f32.cu", "fused_qkv_f32.cu", "tf32x3_wgmma.cuh"
SOURCES = (MLP, QKV, "ffma.cu")
OUT = os.path.join(HERE, "build", "mlp_qkv_f32_variants")
FRESH = "constexpr int kFreshStages = 1;"
STAGES = "constexpr int kStages = 4;"
KEEP = ("  const uint32_t lo = second ? w.y : w.x, hi = second ? w.w : w.z;")
# name -> [(file, text in it, replacement)]
VARIANTS = {
    "this": [],
    "ring_3": [(f, STAGES, "constexpr int kStages = 3;") for f in (MLP, QKV)],
    "fresh_2": [(f, FRESH, "constexpr int kFreshStages = 2;")
                for f in (MLP, QKV)],
    "one_accumulator": [(f, FRESH, "constexpr int kFreshStages = 0;")
                        for f in (MLP, QKV)],
    "philox_pair": [(LOOP, KEEP,
                     "  const uint4 v = philox4x32_10((i + 8) >> 4, seed);\n"
                     "  const uint32_t lo = second ? w.y : w.x, hi = second"
                     " ? v.w : v.z;")],
}
BATCHES = (8, 32)
N, DIM, HEADS, DIM_HEAD, HID = 1001, 1024, 8, 64, 2048
TF32X3_PER_S = 165e12
GEMMS = ("fc1_gelu_kernel", "fc2_residual_kernel", "qkv_gemm_kernel")


def sources_of(name: str) -> dict:
    """The variant's text of each file a variant may change."""
    texts = {f: (_build.CSRC / f).read_text() for f in (MLP, QKV, LOOP)}
    for fname, old, new in VARIANTS[name]:
        if old not in texts[fname]:
            raise ValueError(f"variant {name}: text not in {fname}: "
                             f"{old[:60]!r}")
        texts[fname] = texts[fname].replace(old, new, 1)
    return texts


def build(names) -> dict:
    """Compile each variant into its own library; name -> (library path,
    ptxas's {kernel: (registers, spill bytes)} of its GEMMs)."""
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
            m = re.search("(" + "|".join(GEMMS) + ")", fn)
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


def gemm_ms(fn, iters: int = 10):
    """Device ms a call of the GEMM passes by the profiler; None where the
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
             for e in prof.key_averages()
             if any(g in e.key for g in GEMMS)]
    return sum(times) if times else None


def cases(b: int, rng) -> dict:
    """label -> (kernel call, plain call, GEMM flops) at batch b."""
    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w(out_f, in_f):
        return torch.tensor(rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
                            dtype=torch.float32, device="cuda")

    m, inner = b * N, HEADS * DIM_HEAD
    mlp = (t(b, N, DIM), t(DIM, scale=0.1, offset=1.0), t(DIM, scale=0.1),
           w(HID, DIM), t(HID, scale=0.03), w(DIM, HID), t(DIM, scale=0.02))
    qkv = mlp[:3] + (w(3 * inner, DIM), HEADS, DIM_HEAD)
    drop = {"dropout_rate": 0.1, "seeds": (3, 4), "return_h": True}
    return {
        "K4": (lambda: fused_mlp.fused_mlp_block_f32_cuda(*mlp),
               lambda: fused_mlp.fused_mlp_block_plain(*mlp),
               4 * m * DIM * HID),
        "K4 dropout 0.1 with h": (
            lambda: fused_mlp.fused_mlp_block_f32_cuda(*mlp, **drop)[0],
            lambda: fused_mlp.fused_mlp_block_plain(*mlp, **drop)[0],
            4 * m * DIM * HID),
        "K2": (lambda: fused_qkv.fused_ln_qkv_f32_cuda(*qkv)[0],
               lambda: fused_qkv.fused_ln_qkv_plain(*qkv)[0],
               6 * m * DIM * inner)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mlp_qkv_f32_variants: needs the card", file=sys.stderr)
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
    for b in BATCHES:
        for label, (call, plain, flop) in cases(b, rng).items():
            want = plain()
            order = list(libs)
            turns = {name: [] for name in libs}
            for _ in range(args.rounds):
                for name in order + order[::-1]:
                    use(libs[name])
                    turns[name].append(events_ms(call))
            base = float(np.median(turns["this"]))
            for name in libs:
                use(libs[name])
                got = call()
                torch.cuda.synchronize()
                err = float(((got - want).abs() / (1 + want.abs())).max())
                rel = float((got - want).norm() / want.norm())
                ms = float(np.median(turns[name]))
                dev = gemm_ms(call)
                print(f"{label} batch {b}: {name}: {ms:.4f} ms "
                      f"({ms / base:.3f}x this), GEMMs "
                      + ("not measured" if dev is None else
                         f"device {dev:.4f} ms ({flop / dev / 1e9:.1f} "
                         f"TFLOP/s, {flop / TF32X3_PER_S * 1e3 / dev:.3f} "
                         "of the 3xTF32 bound)")
                      + f", max |err| / (1 + |plain|) {err:.3e}, relative "
                      f"Frobenius {rel:.3e}", flush=True)
            del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
