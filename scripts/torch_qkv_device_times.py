"""Device-only times of K2, the LN + QKV forward, pass by pass: bf16 beside
K17 bf16 at its GEMM's shape, the function's bound and the design's bytes,
and f32 beside f32 ``torch.mm``.

``chip_smoke.py`` times a K2 call with CUDA events around it, which also
counts the wrapper's enqueue (two tensor maps, two launches). This script
reads the device's own kernel times from ``torch.profiler`` (``device_us``
of ``scripts/torch_gemm_device_times.py``): for the flagship block (dim
1024, 8 heads of 64) at batch 1, 8, 32 and 128 (the train step's) x 1001
tokens, each of K2's passes (K4's LayerNorm rows ``ln_rows``, the GEMM
``qkv_gemm``), their sum, the median one-call CUDA-event time and the
host's enqueue time per call, as served (u into a scratch) and, at batch
8 and 128, as trained (u returned); an older checkout's single ``wmma``
kernel shows as ``ln_qkv_kernel``. Each line gives K2's bound (2 M dim 3
inner flops at 989 TFLOP/s, or its bytes at 3.35 TB/s, the larger) and the
design's bytes floor (x read, u written and read again, q, k and v
written, Wqkv read). Then the GEMM pass's yardstick: K17 bf16's GEMM
kernel (its transpose step apart) at [M rounded up to 16, dim] x [dim, 3
inner].

K2 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32, as
served and with u, on chip_smoke.py's f32 operands: each pass's device
time (the weight pre-pass ``split`` on Wqkv, ``ln_rows`` and the GEMM
``qkv_gemm``; an older checkout's FFMA GEMM shows under the same name),
their sum and the one-call CUDA-event time, the GEMM's rate (6 M dim
inner flops) and share of the 3xTF32 bound (165 TFLOP/s), beside f32
``torch.mm`` at [M, dim] x [dim, 3 inner] and the factor between the two
(``scripts/torch_mlp_device_times.py`` f32_lines). ``--other
<checkout>`` routes every kernel call to another checkout's kernel
library: K2 f32 goes through :func:`k2_f32_call`, which hands an older
``nvt_fused_ln_qkv_f32_fwd`` (the FFMA design, no pre-pass) Wqkv itself.

    python scripts/torch_qkv_device_times.py [--iters 20]
        [--only bf16|f32] [--other <checkout>]

Needs the card; prints nvidia-smi's name and power limit first. Copied
into an older checkout's ``scripts/``, it times that checkout's K2.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch import nn  # noqa: E402
from neurovit_tpu_torch.ops import _build, common, fused_qkv  # noqa: E402
from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_attention_device_times import (events_ms,  # noqa: E402
                                          use_checkout)
from torch_gemm_device_times import device_us, enqueue_us  # noqa: E402
from torch_mlp_device_times import f32_lines  # noqa: E402

N, DIM, HEADS, DIM_HEAD = 1001, 1024, 8, 64
INNER = HEADS * DIM_HEAD
BATCHES = (1, 8, 32, 128)
WITH_U = (8, 128)
PASSES = ("ln_rows", "qkv_gemm", "ln_qkv_kernel")
PEAK_BF16, HBM_BYTES_PER_S = 989e12, 3.35e12
F32_BATCHES = (8, 32)


def operands(b: int, dim: int = DIM, heads: int = HEADS,
             dh: int = DIM_HEAD, seed: int = 42) -> tuple:
    """K2's operands for x [b, N, dim], made as chip_smoke.py's kernel
    phase makes them: standard normal x, LN affines near (1, 0), Wqkv [3
    inner, dim] bf16 in nn.Linear's default range."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    w = rng.uniform(-1, 1, (3 * heads * dh, dim)) / dim ** 0.5
    return (t(b, N, dim), t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim, scale=0.1, dtype=torch.float32),
            torch.tensor(w, dtype=torch.bfloat16, device="cuda"), heads, dh)


def floors(m: int, dim: int, inner: int) -> dict:
    """K2's bound (a serving call: x, the LN affines and Wqkv read once, q,
    k and v written once) and by what, and the design's bytes floor, in
    ms, for m rows."""
    t_ops = 2 * m * dim * 3 * inner / PEAK_BF16
    t_bytes = (2 * m * dim + 8 * dim + 6 * inner * dim + 6 * m * inner
               ) / HBM_BYTES_PER_S
    design = (2 * m * dim + 4 * m * dim + 6 * m * inner + 6 * inner * dim
              ) / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "design_ms": design * 1e3}


def short(name: str) -> str:
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int, return_u: bool = False) -> dict:
    """Device microseconds of each pass of one K2 call on ``args``, their
    sum in ms ({} and None where the trace held no kernels), the median
    one-call CUDA-event ms, and the host's enqueue microseconds a call."""
    def call():
        return fused_qkv.fused_ln_qkv_cuda(*args, return_u=return_u)

    passes = {}
    for key, us in device_us(call, iters).items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "events_ms": events_ms(call),
            "enqueue_us": enqueue_us(call, 4 * iters)}


def yardstick(m: int, dim: int, inner: int, iters: int) -> dict:
    """K17 bf16 at [m16, dim] x [dim, 3 inner], m16 = m rounded up to 16:
    {shape: {kernel: device us}}."""
    m16 = -(-m // 16) * 16
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((m16, dim)), dtype=torch.bfloat16,
                     device="cuda")
    b = torch.tensor(rng.standard_normal((dim, 3 * inner)) * dim ** -0.5,
                     dtype=torch.bfloat16, device="cuda")
    dev = device_us(lambda: k17.gemm_bf16_cuda(a, b), iters)
    return {f"[{m16}, {dim}] x [{dim}, {3 * inner}]": {
        short(key): us for key, us in dev.items()}}


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


def k2_f32_call(args: tuple, return_u: bool = False):
    """K2 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library has the forwards' weight pre-pass
    (``nvt_split_f32``); else an older ``nvt_fused_ln_qkv_f32_fwd``, which
    takes Wqkv itself. (q, k, v), and u with ``return_u``."""
    if hasattr(_build.library(), "nvt_split_f32"):
        return fused_qkv.fused_ln_qkv_f32_cuda(*args, return_u=return_u)
    x, gamma, beta, w, heads, dh = args
    b, n, dim = x.shape
    inner = heads * dh
    q, k, v = (x.new_empty(b, n, heads, dh) for _ in range(3))
    u = torch.empty_like(x)
    p = common.ptr
    common.launch("nvt_fused_ln_qkv_f32_fwd",
                  (common.VOID,) * 8 + (common.INT,) * 3 + (common.FLOAT,),
                  x, p(x), p(gamma), p(beta), p(w), p(q), p(k), p(v), p(u),
                  b * n, dim, inner, nn.LN_EPS)
    return (q, k, v, u) if return_u else (q, k, v)


def run_f32(b: int, iters: int) -> list:
    """Lines of K2 f32 at batch b, served and with u, beside f32 torch.mm
    at its GEMM."""
    rng = np.random.default_rng(42)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    w = torch.tensor(rng.uniform(-1, 1, (3 * INNER, DIM)) / DIM ** 0.5,
                     dtype=torch.float32, device="cuda")
    args = (t(b, N, DIM), t(DIM, scale=0.1, offset=1.0), t(DIM, scale=0.1),
            w, HEADS, DIM_HEAD)
    m = b * N
    x2 = args[0].reshape(m, DIM)
    lines = []
    for return_u in (False, True):
        what = (f"K2 f32 batch {b} (M {m}, dim {DIM}, inner {INNER})"
                + (" with u" if return_u else ""))
        lines += f32_lines(
            what, lambda: k2_f32_call(args, return_u),
            {"qkv_gemm": 6 * m * DIM * INNER},
            {} if return_u else {f"[{m}, {DIM}] x [{DIM}, {3 * INNER}]":
                                 lambda: torch.mm(x2, w.t())}, iters)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default=None,
                    help="time only the bf16 K2, or only K2 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_qkv_device_times: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.other:
        use_checkout(os.path.abspath(args.other))
        print(f"kernels of {args.other}")
    if args.only != "f32":
        bf16(args.iters)
    if args.only != "bf16":
        for b in F32_BATCHES:
            for text in run_f32(b, args.iters):
                print(text, flush=True)
            torch.cuda.empty_cache()
    return 0


def bf16(iters: int) -> None:
    """The bf16 K2's lines at each batch, each with K17 bf16's."""
    for b in BATCHES:
        ops = operands(b)
        f = floors(b * N, DIM, INNER)
        what = f"K2 batch {b} (M {b * N}, dim {DIM}, inner {INNER})"
        print(line(what, measure(ops, iters), f), flush=True)
        if b in WITH_U:
            print(line(what + " with u", measure(ops, iters, True), f),
                  flush=True)
        del ops
        for shape, dev in yardstick(b * N, DIM, INNER, iters).items():
            print(f"  K17 bf16 {shape}: " + (", ".join(
                f"{k} {us:.1f} us" for k, us in dev.items()) or
                "device not measured (no kernels traced)"), flush=True)


if __name__ == "__main__":
    sys.exit(main())
