"""Device-only times of the attention forward (K1, K6) and backward (K5,
K6's) beside SDPA's.

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

The backward: K5 at batch 1, 8, 32 and 128 at dropout 0 and 0.1 and K6's
backward at batch 1 and 8 at dropout 0, at the same shapes, on o and the row
sums from the kernel forward and a seeded dO, each timed by the profiler
and by one-call CUDA events (median of 25), beside SDPA's backward:
``torch.autograd.grad`` of ``F.scaled_dot_product_attention`` on the same
q, k, v and dO at dropout 0, its graph built once outside the timed call.
Its rate counts 14 B H N^2 D flops a call (the two passes' seven
products), its bound the 10 B H N^2 D of the minimum five (2.5 times the
forward's).

The f32 forward (``--only f32``, or with the forward): K1 f32 at batch 8
and 32 at dropout 0 and 0.1 (with the row sums) and K6 f32 at batch 1
and 8 at dropout 0, at 1001 tokens and 8 heads of 64, on f32 operands,
by the profiler and by one-call CUDA events (median of 25), beside f32
SDPA's forward on the same tensors, whose kernels' names the first f32
forward line prints. Its rate counts 4 B H N^2 D flops, against the
3xTF32 bound (165 TFLOP/s) and ``mma.sync``'s 3xTF32 ceiling (107
TFLOP/s, a third of its 322 TF32 TFLOP/s measured by
``scripts/torch_mma_tf32_peak.py``).

The f32 backward (with the backward, or ``--only bwd``): K5 f32 at batch
8 and 32 at dropout 0 and 0.1 and K6's backward at f32 at batch 1 and 8
at dropout 0, at 1001 tokens and 8 heads of 64, on f32 operands, o and
the row sums from the f32 forward, timed the same way beside f32 SDPA's
backward on the same tensors (``torch.backends.cuda.matmul.allow_tf32``
off, PyTorch's default), whose kernels' names the first f32 line prints:
the design the yardstick runs. Its rate counts the seven products, 14 B
H N^2 D flops, against the 3xTF32 bound (the five products at 165 TFLOP/s)
and the seven products' FFMA floor (67 TFLOP/s, the CUDA cores).
``--other <checkout>`` routes every kernel call to another checkout's
kernel library (built there), so the parent's kernels are timed with this
script's cases.

    python scripts/torch_attention_device_times.py [--iters 20]
        [--only fwd|bwd|f32] [--other <checkout>]

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
BWD_CASES = (("K5", "bnhd", (1, 8, 32, 128), (0.0, 0.1)),
             ("K6 bwd", "bhnd", (1, 8), (0.0,)))
F32_FWD_CASES = (("K1 f32", "bnhd", (8, 32), (0.0, 0.1)),
                 ("K6 f32", "bhnd", (1, 8), (0.0,)))
F32_BWD_CASES = (("K5 f32", "bnhd", (8, 32), (0.0, 0.1)),
                 ("K6 bwd f32", "bhnd", (1, 8), (0.0,)))
TF32X3_PER_S, FFMA_PER_S, MMA_SYNC_3X_PER_S = 165e12, 67e12, 107e12


def operands(b: int, d: int, layout: str, seed: int = 0,
             dtype=torch.bfloat16) -> list:
    """Seeded q, k, v in ``layout``, on the card."""
    rng = np.random.default_rng(seed)
    shape = (b, N, HEADS, d) if layout == "bnhd" else (b, HEADS, N, d)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                         device="cuda") for _ in range(3)]


def exp2_floor_ms(b: int, n_valid: int = N) -> float:
    return b * HEADS * N * n_valid / EXP2_PER_S * 1e3


def kernel_call(qkv: list, layout: str, rate: float):
    fn = {("bnhd", False): fa.flash_attention_cuda,
          ("bhnd", False): fa.flash_attention_bhnd_cuda,
          ("bnhd", True): fa.flash_attention_f32_cuda,
          ("bhnd", True): fa.flash_attention_bhnd_f32_cuda}[
              layout, qkv[0].dtype == torch.float32]
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
            "library_us": lib_dev,
            "enqueue_us": enqueue_us(kernel, 4 * iters),
            "library_enqueue_us": enqueue_us(lib, 4 * iters)}


def measure_f32_fwd(qkv: list, layout: str, rate: float, iters: int) -> dict:
    """As :func:`measure`, with one-call event times."""
    m = measure(qkv, layout, rate, iters)
    m.update(ms=events_ms(kernel_call(qkv, layout, rate)),
             library_ms=events_ms(sdpa_call(qkv, layout)))
    return m


def f32_fwd_line(name: str, b: int, d: int, rate: float, m: dict) -> str:
    flop = 4 * b * HEADS * N * N * d
    bound_ms = flop / TF32X3_PER_S * 1e3
    ceiling_ms = flop / MMA_SYNC_3X_PER_S * 1e3

    def ms(t):
        return ("not measured" if t is None
                else f"{t:.4f} ms ({flop / t / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / t:.3f} of the bound, {ceiling_ms / t:.3f} of "
                f"mma.sync's ceiling)")

    return (f"{name} B {b} N {N} H {HEADS} D {d} dropout {rate}: device "
            f"{ms(m['device_ms'])}, events {m['ms']:.4f} ms; f32 SDPA device "
            f"{ms(m['library_device_ms'])}, events {m['library_ms']:.4f} ms; "
            f"3xTF32 bound {bound_ms:.4f} ms, mma.sync ceiling "
            f"{ceiling_ms:.4f} ms; enqueue {m['enqueue_us']:.1f} us a call "
            f"(SDPA {m['library_enqueue_us']:.1f})")


def events_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median milliseconds of one call of ``fn`` by CUDA events."""
    for _ in range(warmup):
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


def bwd_calls(qkv: list, layout: str, rate: float, seed: int = 1):
    """The backward kernel's call on qkv (o and the row sums from the kernel
    forward, a seeded dO) and SDPA's backward on the same q, k, v, dO at
    dropout 0, its graph built once here."""
    d = qkv[0].shape[-1]
    kw = dict(scale=d ** -0.5, n_valid=N, dropout_rate=rate, seed=1234)
    f32 = qkv[0].dtype == torch.float32
    fwd, bwd = {
        ("bnhd", False): (fa.flash_attention_cuda,
                          fa.flash_attention_bwd_cuda),
        ("bhnd", False): (fa.flash_attention_bhnd_cuda,
                          fa.flash_attention_bhnd_bwd_cuda),
        ("bnhd", True): (fa.flash_attention_f32_cuda,
                         fa.flash_attention_bwd_f32_cuda),
        ("bhnd", True): (fa.flash_attention_bhnd_f32_cuda,
                         fa.flash_attention_bhnd_bwd_f32_cuda)}[layout, f32]
    o, lsum = fwd(*qkv, return_stats=True, **kw)
    do = operands(qkv[0].shape[0], d, layout, seed, qkv[0].dtype)[0]
    heads_first = [t.transpose(1, 2) if layout == "bnhd" else t
                   for t in qkv + [do]]
    leaves = [t.detach().requires_grad_() for t in heads_first[:3]]
    out = F.scaled_dot_product_attention(*leaves, scale=d ** -0.5)
    return (lambda: bwd(*qkv, o, do, lsum, **kw),
            lambda: torch.autograd.grad(out, leaves, heads_first[3],
                                        retain_graph=True))


def measure_bwd(qkv: list, layout: str, rate: float, iters: int) -> dict:
    """As :func:`measure` for the backward, with one-call event times."""
    kernel, lib = bwd_calls(qkv, layout, rate)
    dev, lib_dev = device_us(kernel, iters), device_us(lib, iters)
    return {"device_ms": sum(dev.values()) / 1e3 if dev else None,
            "library_device_ms": (sum(lib_dev.values()) / 1e3 if lib_dev
                                  else None),
            "ms": events_ms(kernel), "library_ms": events_ms(lib),
            "passes_us": dev, "library_us": lib_dev,
            "enqueue_us": enqueue_us(kernel, 4 * iters),
            "library_enqueue_us": enqueue_us(lib, 4 * iters)}


def bwd_line(name: str, b: int, d: int, rate: float, m: dict) -> str:
    flop = 14 * b * HEADS * N * N * d
    bound_ms = 10 * b * HEADS * N * N * d / PEAK_BF16 * 1e3

    def ms(t):
        return ("not measured" if t is None
                else f"{t:.4f} ms ({flop / t / 1e9:.1f} TFLOP/s)")

    passes = ", ".join(f"{k[:40]} {v:.1f} us"
                       for k, v in sorted(m["passes_us"].items()))
    return (f"{name} B {b} N {N} H {HEADS} D {d} dropout {rate}: device "
            f"{ms(m['device_ms'])} [{passes}], events {m['ms']:.4f} ms; SDPA "
            f"backward device {ms(m['library_device_ms'])}, events "
            f"{m['library_ms']:.4f} ms; bound {bound_ms:.4f} ms; enqueue "
            f"{m['enqueue_us']:.1f} us a call (SDPA "
            f"{m['library_enqueue_us']:.1f})")


def f32_bwd_line(name: str, b: int, d: int, rate: float, m: dict) -> str:
    flop = 14 * b * HEADS * N * N * d
    bound_ms = 10 * b * HEADS * N * N * d / TF32X3_PER_S * 1e3
    floor_ms = flop / FFMA_PER_S * 1e3

    def ms(t):
        return ("not measured" if t is None
                else f"{t:.4f} ms ({flop / t / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / t:.3f} of the bound)")

    passes = ", ".join(f"{k[:40]} {v:.1f} us"
                       for k, v in sorted(m["passes_us"].items()))
    return (f"{name} B {b} N {N} H {HEADS} D {d} dropout {rate}: device "
            f"{ms(m['device_ms'])} [{passes}], events {m['ms']:.4f} ms; f32 "
            f"SDPA backward device {ms(m['library_device_ms'])}, events "
            f"{m['library_ms']:.4f} ms; 3xTF32 bound {bound_ms:.4f} ms, FFMA "
            f"floor {floor_ms:.4f} ms; enqueue {m['enqueue_us']:.1f} us a "
            f"call (SDPA {m['library_enqueue_us']:.1f})")


def use_checkout(tree: str) -> None:
    """Route the wrappers' launches to the kernel library of the checkout
    at ``tree``, built there."""
    import ctypes

    from neurovit_tpu_torch.ops import _build
    out = subprocess.run(
        [sys.executable, "-c", "from neurovit_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=tree,
        env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
        text=True, check=True)
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    _build._function.cache_clear()
    _build.library = lambda: lib


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
    ap.add_argument("--only", choices=("fwd", "bwd", "f32"), default=None,
                    help="time only the forward (bf16 and f32), only the "
                    "backward (bf16 and f32) or only the f32 forward and "
                    "backward")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_device_times: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.other:
        use_checkout(os.path.abspath(args.other))
        print(f"kernels of {args.other}")
    named = set()
    for cases, measure_fn, line_fn, what, heads, dtype in (
            (CASES, measure, line, ("fwd",), (64, 128), torch.bfloat16),
            (F32_FWD_CASES, measure_f32_fwd, f32_fwd_line, ("fwd", "f32"),
             (64,), torch.float32),
            (BWD_CASES, measure_bwd, bwd_line, ("bwd",), (64, 128),
             torch.bfloat16),
            (F32_BWD_CASES, measure_bwd, f32_bwd_line, ("bwd", "f32"), (64,),
             torch.float32)):
        if args.only is not None and args.only not in what:
            continue
        for name, layout, batches, rates in cases:
            for d in heads:
                for b in batches:
                    qkv = operands(b, d, layout, dtype=dtype)
                    for rate in rates:
                        m = measure_fn(qkv, layout, rate, args.iters)
                        if dtype == torch.float32 and what not in named:
                            print(f"f32 SDPA {what[0]}'s kernels: "
                                  + "; ".join(f"{k[:80]} {v:.1f} us"
                                              for k, v in sorted(
                                                  m["library_us"].items())))
                            named.add(what)
                        print(line_fn(name, b, d, rate, m), flush=True)
                    del qkv
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
