"""Device-only times of the out-projections: K3 (bf16, forward), K11 (int8,
serving) pass by pass, and K8 (bf16, backward), beside the GEMM
yardsticks at their shapes; K3 and K8 at f32 pass by pass.

``chip_smoke.py`` times a call with CUDA events around it, which also
counts the wrapper's enqueue (tensor maps and launches). This script reads
the device's own kernel times from ``torch.profiler`` (``device_us`` of
``scripts/torch_gemm_device_times.py``) at the flagship (dim 1024, 8 heads
of 64: inner 512) at batch 1, 8, 32 and 128 x 1001 tokens:

- K3 at dropout 0 and 0.1 (the train step's rate): one launch of K4's
  ``fc2_residual`` pass; an older checkout's ``wmma`` kernel shows as
  ``outproj_kernel``.
- K11: its row quantizer (``rowquant``) and K12's ``fc2_residual`` pass;
  an older checkout's single ``wmma`` kernel shows as
  ``int8_outproj_kernel``.
- K8 at dropout 0 and 0.1: K9's ``dz_rows`` pass without the LayerNorm
  (at dropout 0.1 only) and the ``dattn`` GEMM; an older checkout's
  single ``wmma`` kernel shows under the first 48 characters of its
  name.

Each line gives the function's bound (its bytes at 3.35 TB/s or its
operations at the peak of their type, the larger), the design's bytes
floor (K11 also writes a8 and reads it again; K8 reads dz again at
dropout 0.1 and writes no dz at dropout 0), the median one-call
CUDA-event time and the host's enqueue time per call. Then the
yardsticks, each with its device time and one-call CUDA-event time:
``torch.mm`` with bf16 out and K17 bf16's GEMM kernel at K3's [M, inner]
x [inner, dim]; ``torch._int_mm`` and K17 int8's at K11's; and
``torch.mm(dy, Wout)`` and K17 bf16's at [M, dim] x [dim, inner], K8's
function at dropout 0 (K17 and ``torch._int_mm`` at M rounded up to
16).

K3 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32,
dropout 0 and 0.1, on f32 x and a (standard normal), Wout in nn.Linear's
default range and a small b: each launch's device time apart (the
forwards' weight pre-pass ``split_kernel`` on Wout and K4 f32's
``fc2_residual`` pass; an older checkout's FFMA GEMM shows as
``gemm_kernel``), their sum and the one-call CUDA-event time, the GEMM's
rate (2 M dim inner flops) and share of the 3xTF32 bound, beside f32
``torch.mm(a, Wout^T)``, K3's GEMM alone. ``--other`` routes K3 f32
through :func:`k3_f32_call`, which hands an older
``nvt_fused_outproj_f32_fwd`` (the FFMA design, no pre-pass) Wout itself.

K8 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32,
dropout 0 and 0.1, on f32 dy (scale 0.1) and Wout in nn.Linear's default
range: each launch's device time apart (the weight pre-pass
``split_t_kernel``, ``dz_rows`` at dropout 0.1 and the ``dattn`` GEMM;
an older checkout's FFMA GEMM shows as ``gemm_kernel``), their sum and the
one-call CUDA-event time, the dattn GEMM's rate in TFLOP/s (2 M dim inner
flops) and share of the 3xTF32 bound (165 TFLOP/s) and the FFMA floor (67
TFLOP/s), beside f32 ``torch.mm(dy, Wout)`` (device time of its kernels
and events; ``torch.backends.cuda.matmul.allow_tf32`` off, PyTorch's
default), whose kernels' names the first line prints, and the factor
between the two. ``--other <checkout>`` routes every kernel call to
another checkout's kernel library (built there): K8 f32 goes through
:func:`k8_f32_call`, which hands an older ``nvt_fused_outproj_f32_bwd``
(the FFMA design, no pre-pass) Wout itself.

    python scripts/torch_outproj_device_times.py [--iters 20]
        [--only bf16|f32] [--other <checkout>]

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

from neurovit_tpu_torch.ops import _build, common  # noqa: E402
from neurovit_tpu_torch.ops import fused_outproj as k3  # noqa: E402
from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attention_device_times import (events_ms,  # noqa: E402
                                          use_checkout)
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402

N = 1001
DIM, INNER = 1024, 512
BATCHES = (1, 8, 32, 128)
DROPOUT = 0.1
PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# Kernel names as the profiler shows them, most specific first.
PASSES = ("int8_outproj_kernel", "outproj_kernel", "rowquant_kernel",
          "fc2_residual_kernel", "dz_rows_kernel", "dattn_kernel",
          "split_t_kernel", "split_kernel", "transpose_kernel",
          "gemm_kernel")
F32_BATCHES = (8, 32)
TF32X3_PER_S, FFMA_PER_S = 165e12, 67e12


def operands(b: int, dim: int = DIM, inner: int = INNER,
             seed: int = 42) -> dict:
    """The operands of K3, K11 and K8 for b x N tokens, made as
    chip_smoke.py's kernel phase makes them: standard normal x and a, dy at
    0.1, the weight in nn.Linear's default range (bf16, and int8 per output
    channel from the same f32 values), a small bias."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.tensor(scale * rng.standard_normal(shape), dtype=dtype,
                            device="cuda")

    w = torch.tensor(rng.uniform(-1, 1, (dim, inner)) / inner ** 0.5,
                     dtype=torch.float32, device="cuda")
    return {"x": t(b, N, dim), "a": t(b, N, inner),
            "b": t(dim, scale=0.03, dtype=torch.float32),
            "w": w.to(torch.bfloat16), "w8": q8.quantize_weight(w),
            "dy": t(b, N, dim, scale=0.1)}


def floors(kernel: str, m: int, dim: int = DIM, inner: int = INNER,
           rate: float = DROPOUT) -> dict:
    """The bound of ``kernel`` ("K3", "K11" or "K8") for m rows and by what,
    and the design's bytes floor, in ms. The bytes of the function: each
    input read once and each output written once (K3: a, x, Wout, b in and
    y out; K11: a, x, W8, its scales and b in, y out; K8: dy and Wout in,
    dattn and dz out); its operations 2 m inner dim, bf16 or int8. K11's
    design also writes a8 and its row scales and reads them again; K8's
    reads dz again at dropout ``rate`` > 0 and writes no dz at rate 0
    (dz is dy)."""
    if kernel == "K3":
        nbytes = 2 * m * inner + 4 * m * dim + 2 * dim * inner + 4 * dim
        kind, design = "bf16", nbytes
    elif kernel == "K11":
        nbytes = 2 * m * inner + 4 * m * dim + dim * inner + 8 * dim
        kind, design = "int8", nbytes + 2 * m * inner + 8 * m
    else:
        nbytes = 4 * m * dim + 2 * dim * inner + 2 * m * inner
        kind = "bf16"
        design = nbytes + (2 if rate else -2) * m * dim
    t_ops = 2 * m * inner * dim / PEAK[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "design_ms": design / HBM_BYTES_PER_S * 1e3}


def short(name: str) -> str:
    for key in PASSES:
        if key in name:
            return key
    return name[:48]


def calls(ops: dict, rate: float = DROPOUT) -> dict:
    """name -> one call of each kernel on ``ops``."""
    seed = {"dropout_rate": rate, "seed": 1234}
    return {
        "K3": lambda: k3.fused_outproj_residual_cuda(ops["x"], ops["a"],
                                                     ops["w"], ops["b"]),
        f"K3 dropout {rate}": lambda: k3.fused_outproj_residual_cuda(
            ops["x"], ops["a"], ops["w"], ops["b"], **seed),
        "K11": lambda: q8.int8_outproj_residual_cuda(ops["x"], ops["a"],
                                                     *ops["w8"], ops["b"]),
        "K8": lambda: k3.fused_outproj_bwd_cuda(ops["dy"], ops["w"]),
        f"K8 dropout {rate}": lambda: k3.fused_outproj_bwd_cuda(
            ops["dy"], ops["w"], **seed)}


def measure(call, iters: int) -> dict:
    """Device microseconds of each kernel of one call, their sum in ms ({}
    and None where the trace held no kernels), the median one-call
    CUDA-event ms, and the host's enqueue microseconds a call."""
    passes = {}
    for key, us in device_us(call, iters).items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "events_ms": events_ms(call),
            "enqueue_us": enqueue_us(call, 4 * iters)}


def yardstick(ops: dict, iters: int) -> dict:
    """{call at its shape: ({kernel: device us}, one-call CUDA-event ms)}:
    torch.mm (bf16 out) and K17 bf16 at K3's GEMM, torch._int_mm and K17
    int8 at K11's, torch.mm(dy, Wout) and K17 bf16 at K8's; K17 and
    torch._int_mm at the rows rounded up to 16."""
    b, n, inner = ops["a"].shape
    m, dim = b * n, ops["w"].shape[0]
    m16 = -(-m // 16) * 16
    a2, wt = ops["a"].reshape(m, inner), ops["w"].t().contiguous()
    rng = np.random.default_rng(0)
    a16 = torch.tensor(rng.standard_normal((m16, inner)),
                       dtype=torch.bfloat16, device="cuda")
    a8 = torch.tensor(rng.integers(-127, 128, (m16, inner)),
                      dtype=torch.int8, device="cuda")
    w8t = ops["w8"][0].t().contiguous()
    dy2 = ops["dy"].reshape(m, dim)
    dy16 = torch.tensor(rng.standard_normal((m16, dim)),
                        dtype=torch.bfloat16, device="cuda")
    out = {}
    for name, fn in (
            (f"torch.mm bf16 [{m}, {inner}] x [{inner}, {dim}]",
             lambda: torch.mm(a2, ops["w"].t())),
            (f"K17 bf16 [{m16}, {inner}] x [{inner}, {dim}]",
             lambda: k17.gemm_bf16_cuda(a16, wt)),
            (f"torch._int_mm [{m16}, {inner}] x [{inner}, {dim}]",
             lambda: torch._int_mm(a8, w8t)),
            (f"K17 int8 [{m16}, {inner}] x [{inner}, {dim}]",
             lambda: k17.gemm_int8_cuda(a8, w8t)),
            (f"torch.mm(dy, Wout) [{m}, {dim}] x [{dim}, {inner}]",
             lambda: torch.mm(dy2, ops["w"])),
            (f"K17 bf16 [{m16}, {dim}] x [{dim}, {inner}]",
             lambda: k17.gemm_bf16_cuda(dy16, ops["w"]))):
        out[name] = ({short(key): us for key, us in device_us(
            fn, iters).items()}, events_ms(fn))
    return out


def line(what: str, m: dict, f: dict) -> str:
    if not m["passes_us"]:
        head = f"{what}: device not measured (no kernels traced)"
    else:
        parts = ", ".join(f"{p} {us:.1f}" for p, us in m["passes_us"].items())
        head = f"{what}: device {m['device_ms']:.4f} ms ({parts} us)"
    return (f"{head}; events {m['events_ms']:.4f} ms; bound "
            f"{f['bound_ms']:.4f} ms ({f['bound_by']}), design bytes "
            f"{f['design_ms']:.4f} ms; enqueue {m['enqueue_us']:.1f} us a "
            f"call")


def run(b: int, iters: int) -> tuple:
    """(lines, measured) at batch b: a line for each kernel, then the
    yardsticks' lines; each kernel's :func:`measure` by name."""
    ops = operands(b)
    m = b * N
    lines, measured = [], {}
    for name, call in calls(ops).items():
        what = f"{name} batch {b} (M {m}, dim {DIM}, inner {INNER})"
        measured[name] = measure(call, iters)
        rate = DROPOUT if "dropout" in name else 0.0
        lines.append(line(what, measured[name],
                          floors(name.split()[0], m, rate=rate)))
    for shape, (dev, ms) in yardstick(ops, iters).items():
        lines.append(f"  {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)")
            + f"; events {ms:.4f} ms")
    return lines, measured


def k8_f32_call(dy: torch.Tensor, w: torch.Tensor, rate: float = 0.0,
                seed: int = 1234):
    """K8 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library has the weight pre-pass
    (``nvt_wsplit_f32``); else an older ``nvt_fused_outproj_f32_bwd``,
    which takes Wout [dim, inner] itself. (dattn, dz) either way."""
    if hasattr(_build.library(), "nvt_wsplit_f32"):
        return k3.fused_outproj_bwd_f32_cuda(dy, w, dropout_rate=rate,
                                             seed=seed)
    b, n, dim = dy.shape
    inner = w.shape[1]
    inv_keep, keep_q = common.dropout_args(rate)
    dattn = dy.new_empty(b, n, inner)
    dz = torch.empty_like(dy) if keep_q else None
    common.launch("nvt_fused_outproj_f32_bwd",
                  (common.VOID,) * 4 + (common.INT,) * 3
                  + (common.FLOAT, common.INT, common.U64), dy,
                  common.ptr(dy), common.ptr(w), common.ptr(dattn),
                  common.ptr(dz), b * n, inner, dim, inv_keep, keep_q, seed)
    return dattn, dy if dz is None else dz


def k3_f32_call(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, rate: float = 0.0,
                seed: int = 1234) -> torch.Tensor:
    """K3 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library has no FFMA GEMM
    (``nvt_ffma_gemm_smem_bytes``); else an older
    ``nvt_fused_outproj_f32_fwd``, which takes Wout [dim, inner] itself.
    y either way."""
    if not hasattr(_build.library(), "nvt_ffma_gemm_smem_bytes"):
        return k3.fused_outproj_residual_f32_cuda(x, a, w, b,
                                                  dropout_rate=rate,
                                                  seed=seed)
    bsz, n, dim = x.shape
    inner = a.shape[-1]
    inv_keep, keep_q = common.dropout_args(rate)
    y = torch.empty_like(x)
    common.launch("nvt_fused_outproj_f32_fwd",
                  (common.VOID,) * 5 + (common.INT,) * 3
                  + (common.FLOAT, common.INT, common.U64), x,
                  common.ptr(a), common.ptr(x), common.ptr(w),
                  common.ptr(b), common.ptr(y), bsz * n, inner, dim,
                  inv_keep, keep_q, seed)
    return y


def k3_f32_operands(b: int, seed: int = 43) -> tuple:
    """f32 x [b, N, DIM] and a [b, N, INNER] standard normal, Wout [DIM,
    INNER] in nn.Linear's default range and b [DIM] at 0.03, on the
    card."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    w = torch.tensor(rng.uniform(-1, 1, (DIM, INNER)) / INNER ** 0.5,
                     dtype=torch.float32, device="cuda")
    return t(b, N, DIM), t(b, N, INNER), w, t(DIM, scale=0.03)


def run_k3_f32(b: int, iters: int, named: bool) -> list:
    """Lines of K3 f32 at batch b, dropout 0 and 0.1, beside f32
    torch.mm(a, Wout^T), its GEMM alone; the first names torch.mm's
    kernels unless ``named``."""
    x, a, w, bias = k3_f32_operands(b)
    m = b * N
    flop = 2 * m * DIM * INNER
    bound_ms = flop / TF32X3_PER_S * 1e3
    a2, wt = a.reshape(m, INNER), w.t()
    mm = lambda: torch.mm(a2, wt)  # noqa: E731
    mm_dev = device_us(mm, iters)
    mm_ms = sum(mm_dev.values()) / 1e3 if mm_dev else None
    mm_events = events_ms(mm)
    lines = []
    if not named:
        lines.append("f32 torch.mm(a, Wout^T)'s kernels: " + "; ".join(
            f"{k[:80]} {v:.1f} us" for k, v in sorted(mm_dev.items())))
    for rate in (0.0, 0.1):
        m_ = measure(lambda: k3_f32_call(x, a, w, bias, rate), iters)
        passes = m_["passes_us"]
        gemm_us = passes.get("fc2_residual_kernel", passes.get("gemm_kernel"))
        head = (f"K3 f32 batch {b} (M {m}, dim {DIM}, inner {INNER}) dropout "
                f"{rate}: ")
        if not passes:
            head += "device not measured (no kernels traced)"
        else:
            head += (f"device {m_['device_ms']:.4f} ms (" + ", ".join(
                f"{p} {us:.1f}" for p, us in passes.items()) + " us)")
        if gemm_us:
            head += (f"; GEMM {flop / gemm_us / 1e6:.1f} TFLOP/s, "
                     f"{bound_ms * 1e3 / gemm_us:.3f} of the 3xTF32 bound")
        head += (f"; events {m_['events_ms']:.4f} ms; 3xTF32 bound "
                 f"{bound_ms:.4f} ms; f32 torch.mm(a, Wout^T) device "
                 + ("not measured" if mm_ms is None else f"{mm_ms:.4f} ms")
                 + f", events {mm_events:.4f} ms")
        if mm_ms and m_["device_ms"]:
            head += (f"; K3 f32 / torch.mm: device "
                     f"{m_['device_ms'] / mm_ms:.3f}, events "
                     f"{m_['events_ms'] / mm_events:.3f}")
        lines.append(head + f"; enqueue {m_['enqueue_us']:.1f} us a call")
    return lines


def f32_operands(b: int, seed: int = 42) -> tuple:
    """f32 dy [b, N, DIM] at 0.1 and Wout [DIM, INNER] in nn.Linear's
    default range, on the card."""
    rng = np.random.default_rng(seed)
    dy = torch.tensor(0.1 * rng.standard_normal((b, N, DIM)),
                      dtype=torch.float32, device="cuda")
    w = torch.tensor(rng.uniform(-1, 1, (DIM, INNER)) / INNER ** 0.5,
                     dtype=torch.float32, device="cuda")
    return dy, w


def run_f32(b: int, iters: int, named: bool) -> list:
    """Lines of K8 f32 at batch b, dropout 0 and 0.1, beside f32
    torch.mm(dy, Wout); the first names torch.mm's kernels unless
    ``named``."""
    dy, w = f32_operands(b)
    m = b * N
    flop = 2 * m * DIM * INNER
    bound_ms, floor_ms = flop / TF32X3_PER_S * 1e3, flop / FFMA_PER_S * 1e3
    dy2 = dy.reshape(m, DIM)
    mm = lambda: torch.mm(dy2, w)  # noqa: E731
    mm_dev = device_us(mm, iters)
    mm_ms = sum(mm_dev.values()) / 1e3 if mm_dev else None
    mm_events = events_ms(mm)
    lines = []
    if not named:
        lines.append("f32 torch.mm(dy, Wout)'s kernels: " + "; ".join(
            f"{k[:80]} {v:.1f} us" for k, v in sorted(mm_dev.items())))
    for rate in (0.0, 0.1):
        m_ = measure(lambda: k8_f32_call(dy, w, rate), iters)
        passes = m_["passes_us"]
        gemm_us = passes.get("dattn_kernel", passes.get("gemm_kernel"))
        head = (f"K8 f32 batch {b} (M {m}, dim {DIM}, inner {INNER}) dropout "
                f"{rate}: ")
        if not passes:
            head += "device not measured (no kernels traced)"
        else:
            head += (f"device {m_['device_ms']:.4f} ms (" + ", ".join(
                f"{p} {us:.1f}" for p, us in passes.items()) + " us)")
        if gemm_us:
            head += (f"; GEMM {flop / gemm_us / 1e6:.1f} TFLOP/s, "
                     f"{bound_ms * 1e3 / gemm_us:.3f} of the 3xTF32 bound")
        head += (f"; events {m_['events_ms']:.4f} ms; 3xTF32 bound "
                 f"{bound_ms:.4f} ms, FFMA floor {floor_ms:.4f} ms; f32 "
                 f"torch.mm(dy, Wout) device "
                 + ("not measured" if mm_ms is None else f"{mm_ms:.4f} ms")
                 + f", events {mm_events:.4f} ms")
        if mm_ms and m_["device_ms"]:
            head += (f"; K8 f32 / torch.mm: device "
                     f"{m_['device_ms'] / mm_ms:.3f}, events "
                     f"{m_['events_ms'] / mm_events:.3f}")
        lines.append(head + f"; enqueue {m_['enqueue_us']:.1f} us a call")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default=None,
                    help="time only the bf16 and int8 kernels, or only K3 "
                    "and K8 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_outproj_device_times: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.other:
        use_checkout(os.path.abspath(args.other))
        print(f"kernels of {args.other}")
    if args.only != "f32":
        for b in BATCHES:
            for text in run(b, args.iters)[0]:
                print(text, flush=True)
            torch.cuda.empty_cache()
    if args.only != "bf16":
        for i, b in enumerate(F32_BATCHES):
            for text in run_k3_f32(b, args.iters, named=i > 0):
                print(text, flush=True)
            torch.cuda.empty_cache()
        for i, b in enumerate(F32_BATCHES):
            for text in run_f32(b, args.iters, named=i > 0):
                print(text, flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
