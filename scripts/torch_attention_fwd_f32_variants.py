"""Variants of the f32 attention forward (K1 and K6 at f32,
``csrc/flash_attention_f32.cu`` on ``csrc/tf32x3.cuh``), each built apart
and timed in turns against the source as it is, to show what each of the
design's choices buys:

- ``q_resident``: Q's split fragments loaded once and kept in registers
  (at D <= 64), where the design loads them from the Q box again each
  stage;
- ``three_blocks``: three blocks an SM (at most 168 registers a thread),
  where the design fits two;
- ``cp_async``: warp 0's 32 lanes copy the K and V boxes by 16-byte
  ``cp.async`` into the same swizzled layout, zero-filling keys past N,
  and signal the stage's full barrier by
  ``cp.async.mbarrier.arrive.noinc``, where the design has thread 0 load
  them by TMA;
- ``fresh_s_2``, ``fresh_s_4``: S's fresh accumulator every two or four
  k8 steps (the design: eight, all of D <= 64), the loop over D unrolled;
- ``fresh_pv_2``: P V's fresh accumulator every two k8 steps (16 keys;
  the design: a stage's four, 32 keys);
- ``one_accumulator``: S in one accumulator over D and each 8 columns of O
  in one over every key (an MMA rounds toward zero);
- ``pv_tiles_2``: P V two 8-column tiles of O at a time (the design: four);
- ``ex2_approx``: p's exp2 by one MUFU op (``ex2.approx.ftz``, the bf16
  kernel's ``capped_exp2``) where the design calls ``exp2f``;
- ``no_split`` (a diagnostic, its results wrong): the operands passed to
  the MMAs unsplit and small = 0, so the time without the splits.

Each variant is the source with a few lines replaced (``VARIANTS``;
``tests/test_torch_flash_fwd_tf32x3.py`` checks that every replaced text
is in it), compiled into ``build/attention_fwd_f32_variants/<name>/``
(one nvcc each, in parallel, for sm_90a). At the flagship block (batch 8
and 32 x 1001 tokens, 8 heads of 64; dropout 0, and 0.1 with the row sums
at batch 8): each variant's time in turns (``--rounds`` of this, the
variants, then back; each turn the median of 10 CUDA-event timings of
``flash_attention_f32_cuda`` routed to that variant's library), its
largest |got - plain| / (1 + |plain|) and o's relative Frobenius error
against the plain forward on the card, and the profiler's device time of
the kernel; with ptxas's registers and spills, and the card's name and
power limit.

    python scripts/torch_attention_fwd_f32_variants.py [--rounds 3]
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

SOURCE = "flash_attention_f32.cu"
HEADER = "tf32x3.cuh"
SPLIT = ("  big = rna_tf32(x);\n"
         "  small = __float_as_uint(__uint_as_float(x) - "
         "__uint_as_float(big));")
OUT = os.path.join(HERE, "build", "attention_fwd_f32_variants")
TMA_STAGE = '''  auto load_stage = [&](int st, int t) {
    hopper::mbar_expect_tx(&full[st], 2 * kKV * 4);
    for (int p = 0; p < P::kPanels; ++p) {
      flash::load_box<kBhnd>(ks + st * kKV + p * kBKV * 32, &tk, &full[st],
                             32 * p, t * kBKV, gt.h, gt.b);
      flash::load_box<kBhnd>(vs + st * kKV + p * kBKV * 32, &tv, &full[st],
                             32 * p, t * kBKV, gt.h, gt.b);
    }
  };'''
CP_ASYNC_STAGE = '''  const HeadRows<kBhnd> hr_copy(gt.b, gt.h, N, H, D);
  auto load_stage = [&](int st, int t) {
    for (int c = threadIdx.x; c < kBKV * D / 4; c += kCopiers) {
      const int r = c / (D / 4), col = 4 * (c % (D / 4));
      const bool valid = t * kBKV + r < N;
      const size_t at =
          hr_copy.base +
          static_cast<size_t>(valid ? t * kBKV + r : 0) * hr_copy.stride +
          col;
      const int to = st * kKV + tf32x3::swz128<kBKV>(r, col);
      ffma::cp_async16(ks + to, kg + at, valid);
      ffma::cp_async16(vs + to, vg + at, valid);
    }
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(
            smem_u32(&full[st]))
        : "memory");
  };'''
UNROLL = ("#pragma unroll 1\n  for (int k0 = 0; k0 < D; k0 += 8 * "
          "kSteps<D>) {")
PV_ADD = ("#pragma unroll\n      for (int n = 0; n < kNC; ++n) "
          "tf32x3::add_to(acc[n0 + n], d[n]);\n")
# name -> [(file, text in it, replacement)]
VARIANTS = {
    "this": [],
    "q_resident": [(SOURCE, "constexpr bool kQResident = false;",
                    "constexpr bool kQResident = D <= 64;")],
    "three_blocks": [(SOURCE, "constexpr int kMinBlocks = 2;",
                      "constexpr int kMinBlocks = 3;")],
    "cp_async": [
        (SOURCE, "constexpr int kCopiers = 1;",
         "constexpr int kCopiers = 32;"),
        (SOURCE, "float* __restrict__ o, float* __restrict__ lsum,\n",
         "float* __restrict__ o, float* __restrict__ lsum,\n"
         "                         const float* __restrict__ kg,\n"
         "                         const float* __restrict__ vg,\n"),
        (SOURCE, "maps[0], maps[1], maps[2], o, lsum, ",
         "maps[0], maps[1], maps[2], o, lsum, static_cast<const float*>(k), "
         "static_cast<const float*>(v), "),
        (SOURCE, TMA_STAGE, CP_ASYNC_STAGE)],
    "fresh_s_2": [(SOURCE, "constexpr int kSteps = D <= 64 ? 8 : 2;",
                   "constexpr int kSteps = 2;"),
                  (SOURCE, UNROLL, UNROLL.replace(" 1\n", "\n"))],
    "fresh_s_4": [(SOURCE, "constexpr int kSteps = D <= 64 ? 8 : 2;",
                   "constexpr int kSteps = 4;"),
                  (SOURCE, UNROLL, UNROLL.replace(" 1\n", "\n"))],
    "fresh_pv_2": [(SOURCE, "constexpr int kPvSteps = kNT;",
                    "constexpr int kPvSteps = 2;")],
    "one_accumulator": [
        (SOURCE, "  for (int k0 = 0; k0 < D; k0 += 8 * kSteps<D>) {",
         "  for (int k0 = 0; k0 < D; k0 += D) {"),
        (SOURCE, "    for (int kk = k0; kk < k0 + 8 * kSteps<D> && kk < D; "
         "kk += 8) {", "    for (int kk = k0; kk < D; kk += 8) {"),
        (SOURCE, "        tf32x3::mma3_rz_n(d, pa, fb);",
         "        tf32x3::mma3_rz_n(\n"
         "            *reinterpret_cast<float(*)[kNC][4]>(&acc[n0]), pa, "
         "fb);"),
        (SOURCE, PV_ADD, "")],
    "pv_tiles_2": [(SOURCE, "constexpr int kNC = 4;",
                    "constexpr int kNC = 2;")],
    "ex2_approx": [(SOURCE, "exp2f(fminf(fmaxf(s[j][e] * scale_log2, -kCap), "
                    "kCap));", "flash::capped_exp2(s[j][e], scale_log2);")],
    "no_split": [(HEADER, SPLIT, "  big = x;\n  small = 0u;")],
}
CASES = ((8, 0.0), (8, 0.1), (32, 0.0))
N, H, D = 1001, 8, 64


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
    ptxas's {D: (registers, spill bytes)} of the bnhd instances)."""
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
        kernels, _ = _build.ptxas_report("== " + SOURCE + "\n" + log)
        regs = {}
        for _, fn, used, stores, loads in kernels:
            m = re.search(r"flash_fwd_f32_kernelILi(\d+)ELb0", fn)
            if m:
                regs[int(m.group(1))] = (used, stores + loads)
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


def device_ms(fn, iters: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "flash_fwd_f32_kernel" in e.key) / iters / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_fwd_f32_variants: needs the card",
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
            f"<D {d}> {r} registers, {s} bytes spilled"
            for d, (r, s) in sorted(regs.items())))
    rng = np.random.default_rng(0)
    for b, rate in CASES:
        qkv = [torch.tensor(rng.standard_normal((b, N, H, D)),
                            dtype=torch.float32, device="cuda")
               for _ in range(3)]
        kw = dict(scale=D ** -0.5, n_valid=N, dropout_rate=rate, seed=3,
                  return_stats=rate > 0)
        want = fa.flash_attention_plain(*qkv, **kw)
        want = want if isinstance(want, tuple) else (want,)
        flop = 4 * b * H * N * N * D

        def call():
            return fa.flash_attention_f32_cuda(*qkv, **kw)
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
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            err = max(float(((g - w).abs() / (1 + w.abs())).max())
                      for g, w in zip(got, want))
            rel = float((got[0] - want[0]).norm() / want[0].norm())
            ms = float(np.median(turns[name]))
            dev = device_ms(call)
            print(f"B {b} N {N} H {H} D {D} dropout {rate} {name}: "
                  f"{ms:.4f} ms ({ms / base:.3f}x this), device {dev:.4f} "
                  f"ms ({flop / dev / 1e9:.1f} TFLOP/s), max |err| / (1 + "
                  f"|plain|) {err:.3e}, o's relative Frobenius {rel:.3e}",
                  flush=True)
        del qkv, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
