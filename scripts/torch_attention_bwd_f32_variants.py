"""Variants of the f32 attention backward (K5 f32 and K6's backward at
f32, ``csrc/flash_attention_bwd_f32.cu`` on ``csrc/tf32x3.cuh``), each
built apart and timed in turns against the sources as they are, to show
what each of the design's choices buys:

- ``cvt_big``: big = ``cvt.rna.tf32.f32`` (the same rounding as the
  integer add and mask of ``rna_tf32``);
- ``cvt_small``: small rounded to TF32 by ``cvt.rna`` too, where the
  design passes x - big and lets the tensor cores read its top 19 bits;
- ``one_accumulator``: every product summed in one MMA accumulator over
  its whole k (S and dP over D, dQ, dK and dV over every key or query
  tile), where the design sums a few k steps in a fresh accumulator and
  adds that in f32 (an MMA rounds toward zero);
- ``no_split`` (a diagnostic, its results wrong): the operands passed to
  the MMAs unsplit and small = 0, so the time without the splits.

Each variant is the sources with a few lines replaced (``VARIANTS``;
``tests/test_torch_tf32x3.py`` checks that every replaced text is in
them), compiled into ``build/attention_bwd_f32_variants/<name>/`` (one
nvcc each, in parallel, for sm_90a). At the flagship block (batch 8 x
1001 tokens, 8 heads of 64) and at 2 x 2 heads of 128, dropout 0 and
0.1: each variant's time in turns (``--rounds`` of this, the variants,
then back; each turn the median of 10 CUDA-event timings of
``flash_attention_bwd_f32_cuda`` routed to that variant's library), its
largest |got - plain| / (1 + |plain|) and its relative Frobenius error
of dq, dk and dv against the plain backward on the card, and at batch 8
the profiler's device time of each pass; with ptxas's registers and
spills, and the card's name and power limit.

    python scripts/torch_attention_bwd_f32_variants.py [--rounds 3]
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
from neurovit_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_bwd_f32.cu"
HEADER = "tf32x3.cuh"
OUT = os.path.join(HERE, "build", "attention_bwd_f32_variants")
SPLIT = ('''  big = rna_tf32(x);
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));''')
# name -> [(file, text in it, replacement)]
VARIANTS = {
    "this": [],
    "cvt_big": [(HEADER, SPLIT, '''  const float f = __uint_as_float(x);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(f));
  small = __float_as_uint(f - __uint_as_float(big));''')],
    "cvt_small": [(HEADER, SPLIT, '''  big = rna_tf32(x);
  const float rest = __uint_as_float(x) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(rest));''')],
    "one_accumulator": [
        (SOURCE, "  for (int k0 = 0; k0 < D; k0 += 8 * kSteps) {",
         "  for (int k0 = 0; k0 < D; k0 += D) {"),
        (SOURCE, "    for (int kk = k0; kk < k0 + 8 * kSteps; kk += 8) {",
         "    for (int kk = k0; kk < D; kk += 8) {"),
        (SOURCE, "      tf32x3::mma3_rz(d, xa[j], fb);",
         "      tf32x3::mma3_rz(acc[n], xa[j], fb);"),
        (SOURCE, "    tf32x3::add_to(acc[n], d);\n", "")],
    "no_split": [(HEADER, SPLIT, "  big = x;\n  small = 0u;")],
}
CASES = ((8, 8, 64), (2, 2, 128))
N = 1001


def sources_of(name: str) -> dict:
    """The variant's texts of the two files it may change."""
    texts = {f: (_build.CSRC / f).read_text() for f in (SOURCE, HEADER)}
    for fname, old, new in VARIANTS[name]:
        if old not in texts[fname]:
            raise ValueError(f"variant {name}: text not in {fname}: "
                             f"{old[:60]!r}")
        texts[fname] = texts[fname].replace(old, new, 1)
    return texts


def build(names) -> dict:
    """Compile each variant into its own library; name -> (library path,
    ptxas's {(pass, D): (registers, spill bytes)})."""
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
             os.path.join(tree, SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = {}
        for fn, spill, used in re.findall(
                r"Compiling entry function '([^']+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log, re.S):
            m = re.search(r"(dq|dkv)_f32_kernelILi(\d+)ELb0", fn)
            if m:
                regs[m.group(1), int(m.group(2))] = (int(used), int(spill))
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


def passes_ms(fn, iters: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {("dq" if "dq_f32" in e.key else "dkv"):
            e.self_device_time_total / iters / 1e3
            for e in prof.key_averages() if "_f32_kernel" in e.key}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_bwd_f32_variants: needs the card",
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
            f"{p}<{d}> {r} registers, {s} bytes spilled"
            for (p, d), (r, s) in sorted(regs.items())))
    rng = np.random.default_rng(0)
    for b, h, d in CASES:
        qkv = [torch.tensor(rng.standard_normal((b, N, h, d)),
                            dtype=torch.float32, device="cuda")
               for _ in range(4)]
        for rate in (0.0, 0.1):
            kw = dict(scale=d ** -0.5, n_valid=N, dropout_rate=rate, seed=3)
            o, lsum = fa.flash_attention_plain(*qkv[:3], return_stats=True,
                                               **kw)
            want = fa.flash_attention_bwd_plain(*qkv[:3], o, qkv[3], lsum,
                                                **kw)

            def call():
                return fa.flash_attention_bwd_f32_cuda(*qkv[:3], o, qkv[3],
                                                       lsum, **kw)
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
                err = max(float(((g - w).abs() / (1 + w.abs())).max())
                          for g, w in zip(got, want))
                rel = " ".join(f"{float((g - w).norm() / w.norm()):.3e}"
                               for g, w in zip(got, want))
                ms = float(np.median(turns[name]))
                line = (f"B {b} N {N} H {h} D {d} dropout {rate} {name}: "
                        f"{ms:.4f} ms ({ms / base:.3f}x this), max |err| / "
                        f"(1 + |plain|) {err:.3e}, relative Frobenius dq dk "
                        f"dv {rel}")
                if b == 8:
                    split = passes_ms(call)
                    line += "; device " + ", ".join(
                        f"{k} {v:.4f} ms" for k, v in sorted(split.items()))
                print(line, flush=True)
        del qkv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
