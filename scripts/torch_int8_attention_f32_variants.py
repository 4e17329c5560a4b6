"""Variants of K13 at f32 (``csrc/int8_attention_f32.cu``: QK^T in 3xTF32
on ``mma.sync`` in two sweeps, P8 . V8 on s8 ``mma.sync``), each built
apart and timed in turns against the source as it is, to show what each
of the design's choices buys and where its time goes:

- ``q_reload``: Q's fragments loaded from the Q box again each k8 step
  at D = 64 too, as at D = 128, where the design keeps them in registers;
- ``three_blocks``: ``q_reload`` at three blocks an SM (at most 168
  registers a thread), where the design fits two (at most 255);
- ``stages_2``: a ring of two stages (the design: three);
- ``unroll_4``: the k8 steps of S unrolled four at a time at D = 64 (the
  design: all eight);
- ``exp2f``: p's exp2, and rowmax(p)'s, by CUDA's ``exp2f``, where the
  design takes one MUFU op (``ex2.approx.ftz``, the bf16 K13's
  ``capped_exp2``): both are ``ex2.approx`` on the clamp's range, whose
  results are normal, and exp2f adds a rescaling for subnormal results;
- ``window_16``, ``window_18``: the scores taken again in the plain
  version's order where x = p / s_p lies within x 2^-16 or 2^-18 of a
  half-integer (the design: x 2^-17);
- ``no_recompute`` (a diagnostic of the recompute's cost): no score near
  a code's rounding boundary summed again in the plain version's order;
- ``one_accumulator`` (a diagnostic of the fresh accumulator's cost): S in
  one accumulator over D, whose sums round toward zero and drift;
- ``no_split`` (a diagnostic, its results wrong): the operands passed to
  the MMAs unsplit and small = 0, so the time without the splits.

Each variant is the source with a few lines replaced (``VARIANTS``;
``tests/test_torch_int8_f32.py`` checks that every replaced text is in
it), compiled with the prologue's source (``int8_attention.cu``, built
once) into ``build/int8_attention_f32_variants/<name>/`` (one nvcc each,
in parallel, for sm_90a). At the flagship block (1001 tokens, 8 heads of
64, n_valid 1001) at batch 8 and 32, and at batch 8 with q and k scaled
so that the scores spread as the random-weight flagship's: each variant's
time in turns
(``--rounds`` of this, the variants, then back; each turn the median of 10
CUDA-event timings of ``int8_flash_attention_f32_cuda`` routed to that
variant's library), the profiler's device time of its attention kernel,
the query rows outside F32_TOL (1 + |plain|) against the plain version on
the card (``chip_smoke.py``'s ``int8_attn_f32_rows``; at most 1 % pass
``hold_int8_attn_f32``), with ptxas's registers and spills, and the
card's name and power limit.

    python scripts/torch_int8_attention_f32_variants.py [--rounds 3]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from neurovit_tpu_torch import nn  # noqa: E402
from neurovit_tpu_torch.ops import _build  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402

SOURCE = "int8_attention_f32.cu"
PROLOGUE = "int8_attention.cu"
HEADER = "tf32x3.cuh"
SPLIT = ("  big = rna_tf32(x);\n"
         "  small = __float_as_uint(__uint_as_float(x) - "
         "__uint_as_float(big));")
OUT = os.path.join(HERE, "build", "int8_attention_f32_variants")
FRESH = ("      float ts[kNT][4];\n#pragma unroll\n      for (int j = 0; "
         "j < kNT; ++j) tf32x3::zero(ts[j]);\n"
         "      tf32x3::mma3_rz_n(ts, fa, fb);\n"
         "#pragma unroll\n      for (int j = 0; j < kNT; ++j) "
         "tf32x3::add_to(s[j], ts[j]);")
UNROLL = "constexpr int kUnroll = D <= 64 ? D / 8 : 2;"
WINDOW = "__fmaf_rn(-x, 0x1p-17f, 0.5f)"
RESIDENT = "constexpr bool kQResident = D <= 64;"
EXP2_P = "flash::capped_exp2(s[j][e], scale_log2e)"
EXP2_MAX = "flash::exp2_ftz(fminf(fmaxf(mx, -kScoreCap), kScoreCap))"
# name -> [(file, text in it, replacement)]
VARIANTS = {
    "this": [],
    "q_reload": [(SOURCE, RESIDENT, "constexpr bool kQResident = false;")],
    "three_blocks": [(SOURCE, RESIDENT, "constexpr bool kQResident = false;"),
                     (SOURCE, "constexpr int kMinBlocks = 2;",
                      "constexpr int kMinBlocks = 3;")],
    "stages_2": [(SOURCE, "static constexpr int kStages = 3;",
                  "static constexpr int kStages = 2;")],
    "unroll_4": [(SOURCE, UNROLL,
                  "constexpr int kUnroll = D <= 64 ? 4 : 2;")],
    "exp2f": [(SOURCE, EXP2_P, "exp2f(fminf(fmaxf(__fmul_rn(s[j][e], "
               "scale_log2e), -kScoreCap), kScoreCap))"),
              (SOURCE, EXP2_MAX,
               EXP2_MAX.replace("flash::exp2_ftz", "exp2f"))],
    "window_16": [(SOURCE, WINDOW, WINDOW.replace("-17", "-16"))],
    "window_18": [(SOURCE, WINDOW, WINDOW.replace("-17", "-18"))],
    "no_recompute": [(SOURCE, "    if (near) {", "    if (false) {")],
    "one_accumulator": [(SOURCE, FRESH,
                         "      tf32x3::mma3_rz_n(s, fa, fb);")],
    "no_split": [(HEADER, SPLIT, "  big = x;\n  small = 0u;")],
}
# (batch, q and k scaled by): N(0, 1) operands, and at 0.58 scores that
# spread as the random-weight flagship's do (t's standard deviation 0.48:
# near-uniform rows, most codes large).
CASES = ((8, 1.0), (32, 1.0), (8, 0.58))
N, H, D = 1001, 8, 64


def sources_of(name: str) -> dict:
    """The variant's texts of the two files it may change; each
    replacement takes the first occurrence still there."""
    texts = {f: (_build.CSRC / f).read_text() for f in (SOURCE, HEADER)}
    for fname, old, new in VARIANTS[name]:
        if old not in texts[fname]:
            raise ValueError(f"variant {name}: text not in {fname}: "
                             f"{old[:60]!r}")
        texts[fname] = texts[fname].replace(old, new, 1)
    return texts


def build(names) -> dict:
    """Compile the prologue once, then each variant with it into its own
    library; name -> (library path, ptxas's {D: (registers, spill bytes)}
    of the attention kernel's instances)."""
    nvcc = _build.find_nvcc()
    os.makedirs(OUT, exist_ok=True)
    prologue = os.path.join(OUT, "prologue.o")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-I", str(_build.CSRC),
                    "-o", prologue, str(_build.CSRC / PROLOGUE)],
                   check=True, capture_output=True, text=True)
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
             os.path.join(tree, SOURCE), prologue], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernels, _ = _build.ptxas_report("== " + SOURCE + "\n" + log)
        regs = {}
        for _, fn, used, stores, loads in kernels:
            m = re.search(r"int8_attn_f32_kernelILi(\d+)E", fn)
            if m:
                regs[int(m.group(1))] = (used, stores + loads)
        out[name] = (lib, regs)
    return out


def use(lib: ctypes.CDLL) -> None:
    _build._function.cache_clear()
    _build.library = lambda: lib


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
               if "int8_attn_f32_kernel" in e.key) / iters / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_attention_f32_variants: needs the card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    cs = chip_smoke()
    built = build(VARIANTS)
    libs = {name: ctypes.CDLL(lib) for name, (lib, _) in built.items()}
    for name, (_, regs) in built.items():
        print(f"{name}: ptxas " + ", ".join(
            f"<D {d}> {r} registers, {s} bytes spilled"
            for d, (r, s) in sorted(regs.items())))
    rng = np.random.default_rng(0)
    for b, qk in CASES:
        qkv = [torch.tensor(rng.standard_normal((b, N, H, D)) * f,
                            dtype=torch.float32, device="cuda")
               for f in (qk, qk, 1.0)]
        kw = dict(scale=D ** -0.5, n_valid=N)
        with nn.full_f32(torch.float32):
            want = q8.int8_flash_attention_plain(*qkv, **kw)
        ops = 2 * 2 * b * H * N * N * D       # the two sweeps' QK^T

        def call():
            return q8.int8_flash_attention_f32_cuda(*qkv, **kw)
        order = list(libs)
        turns = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                use(libs[name])
                turns[name].append(events_ms(call))
        base = float(np.median(turns["this"]))
        use(libs["this"])
        this = call()
        for name in libs:
            use(libs[name])
            got = call()
            torch.cuda.synchronize()
            over, rows, ok = cs.int8_attn_f32_rows(got, want)
            same = bool(torch.equal(got, this))
            ms = float(np.median(turns[name]))
            dev = device_ms(call)
            print(f"B {b} N {N} H {H} D {D} q, k x {qk} {name}: {ms:.4f} ms "
                  f"({ms / base:.3f}x this), attention device {dev:.4f} ms "
                  f"({ops / dev / 1e9:.1f} TFLOP/s of the two sweeps' "
                  f"QK^T), {over} of {rows} query rows outside F32_TOL "
                  f"(1 + |plain|), within ATOL + RTOL |plain| {ok}, "
                  f"bit-equal to this {same}",
                  flush=True)
            del got
        del qkv, want, this
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
