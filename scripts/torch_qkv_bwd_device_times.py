"""Device-only times of K7, the LN + QKV backward, pass by pass, beside K17
bf16 at its GEMM's shape, the function's bound and the design's bytes.

``chip_smoke.py`` times a K7 call with CUDA events around it, which also
counts the wrapper's enqueue (two tensor maps, four launches). This script
reads the device's own kernel times from ``torch.profiler``: for the
flagship block (dim 1024, 8 heads of 64) at batch 1, 8, 32 and 128 (the
train step's) x 1001 tokens, each of K7's passes (row statistics, the du
GEMM, the LayerNorm backward rows, the column sums), their sum and the
host's enqueue time per call; beside them, K17 bf16's GEMM kernel (and its
transpose step, apart) at du's [M, 3 inner] x [3 inner, dim], M rounded up
to 16, which K17 needs; the function's bound (2 M 3 inner dim flops at 989
TFLOP/s, or its bytes at 3.35 TB/s, the larger); and the design's bytes
floor (dqkv and Wqkv read once, x three times, du written and read as f32,
dx written, the partial sums written and read, at 3.35 TB/s).

An older checkout's K7 (on ``wmma``: ``du_gemm_kernel``, ``ln_bwd_kernel``
and two ``colsum_kernel`` launches) takes dq, dk and dv apart; copy this
script into that checkout's ``scripts/`` to time it there.

K7 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32, on
chip_smoke.py's f32 operands: each pass's device time (``wsplit``, the
weight pre-pass on Wqkv; ``row_stats``; the GEMM ``du``; ``ln_bwd``;
``colsum``; an older checkout's FFMA du pass under the same name), their
sum and the one-call CUDA-event time, the GEMM's rate in TFLOP/s (2 M 3
inner dim flops) and share of the 3xTF32 bound (165 TFLOP/s), beside f32
``torch.mm`` at du's [M, 3 inner] x [3 inner, dim] (``allow_tf32`` off)
and the factor between the two. ``--other <checkout>`` routes every
kernel call to another checkout's kernel library (built there): K7 f32
goes through :func:`k7_f32_call`, which hands an older
``nvt_fused_ln_qkv_f32_bwd`` (the FFMA design, no pre-pass) Wqkv itself.

    python scripts/torch_qkv_bwd_device_times.py [--iters 20]
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

from neurovit_tpu_torch import nn  # noqa: E402
from neurovit_tpu_torch.ops import _build, common, fused_qkv  # noqa: E402
from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gemm_device_times as gemm_times  # noqa: E402
import torch_mlp_device_times as k4_times  # noqa: E402
from torch_attention_device_times import use_checkout  # noqa: E402
from torch_mlp_bwd_device_times import f32_short, scratch_bytes  # noqa: E402

N, DIM, HEADS, DIM_HEAD = 1001, 1024, 8, 64
INNER = HEADS * DIM_HEAD
PASSES = ("row_stats", "du_kernel", "du_gemm_kernel", "ln_bwd", "colsum")
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def operands(b: int, dim: int = DIM, inner: int = INNER, seed: int = 42
             ) -> tuple:
    """K7's operands for x [b, N, dim], made as chip_smoke.py's kernel
    phase makes them: (dqkv, x, gamma, w) with dqkv = [dq | dk | dv]
    [b, N, 3 inner] standard normal times 0.1, standard normal x, gamma
    near 1, Wqkv [3 inner, dim] bf16 in nn.Linear's default range."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    w = rng.uniform(-1, 1, (3 * inner, dim)) / dim ** 0.5
    return (t(b, N, 3 * inner, scale=0.1), t(b, N, dim),
            t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
            torch.tensor(w, dtype=torch.bfloat16, device="cuda"))


def call(dqkv, x, gamma, w):
    """One K7 call on the operands through this checkout's wrapper: on
    dqkv itself, or on its three [b, N, heads, dim_head] parts where the
    checkout's K7 takes dq, dk and dv apart (no ``qkv_bwd_plan``)."""
    if hasattr(fused_qkv, "qkv_bwd_plan"):
        return lambda: fused_qkv.fused_ln_qkv_bwd_cuda(dqkv, x, gamma, w)
    b, n, _ = x.shape
    parts = [p.reshape(b, n, -1, DIM_HEAD).contiguous()
             for p in dqkv.chunk(3, dim=2)]
    return lambda: fused_qkv.fused_ln_qkv_bwd_cuda(*parts, x, gamma, w)


def floors_ms(m: int, dim: int = DIM, inner: int = INNER) -> tuple:
    """(the function's bound, the design's bytes floor) in ms for m rows."""
    k = 3 * inner
    ops = 2 * m * k * dim / BF16_OPS_PER_S
    io = (m * k * 2 + k * dim * 2 + m * dim * 2 + dim * 4
          + m * dim * 2 + 2 * dim * 4) / HBM_BYTES_PER_S
    col_tiles = -(-dim // (64 if -(-dim // 128) * -(-m // 128) < 132
                           else 128))
    design = (m * k * 2 + k * dim * 2 + 3 * m * dim * 2 + 2 * m * dim * 4
              + m * dim * 2 + 2 * (2 * m * col_tiles * 4)
              + 2 * (2 * -(-m // 128) * dim * 4) + 2 * m * 8)
    return max(ops, io) * 1e3, design / HBM_BYTES_PER_S * 1e3


def short(name: str) -> str:
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int) -> dict:
    """Device microseconds of each pass of one K7 call on ``args``, their
    sum in ms ({} and None where the trace held no kernels), and the
    host's enqueue microseconds a call."""
    fn = call(*args)
    dev = gemm_times.device_us(fn, iters)
    passes = {}
    for key, us in dev.items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "enqueue_us": gemm_times.enqueue_us(fn, 4 * iters)}


def yardstick(m: int, dim: int, inner: int, iters: int) -> dict:
    """K17 bf16 at du's [m, 3 inner] x [3 inner, dim] (m rounded up to 16):
    {shape: {kernel: device us}}."""
    m16 = -(-m // 16) * 16
    rng = np.random.default_rng(0)
    k = 3 * inner
    a = torch.tensor(rng.standard_normal((m16, k)), dtype=torch.bfloat16,
                     device="cuda")
    b = torch.tensor(rng.standard_normal((k, dim)) * k ** -0.5,
                     dtype=torch.bfloat16, device="cuda")
    dev = gemm_times.device_us(lambda: k17.gemm_bf16_cuda(a, b), iters)
    return {f"du [{m16}, {k}] x [{k}, {dim}]": {
        short(key): us for key, us in dev.items()}}


def line(what: str, m: dict, rows: int) -> str:
    bound, design = floors_ms(rows)
    if not m["passes_us"]:
        return f"{what}: device not measured (no kernels traced)"
    parts = ", ".join(f"{p} {us:.1f}" for p, us in m["passes_us"].items())
    return (f"{what}: device {m['device_ms']:.4f} ms ({parts} us); bound "
            f"{bound:.4f} ms, design's bytes {design:.4f} ms; enqueue "
            f"{m['enqueue_us']:.1f} us a call")


def k7_f32_call(dqkv, x, gamma, w):
    """K7 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library's K7 f32 runs on the 3xTF32 Loop
    (``nvt_fused_ln_qkv_f32_bwd_smem_bytes``); else an older
    ``nvt_fused_ln_qkv_f32_bwd``, which takes Wqkv itself. (dx, dgamma,
    dbeta)."""
    if hasattr(_build.library(), "nvt_fused_ln_qkv_f32_bwd_smem_bytes"):
        return fused_qkv.fused_ln_qkv_bwd_f32_cuda(dqkv, x, gamma, w)
    b, n, dim = x.shape
    inner = dqkv.shape[-1] // 3
    dx = torch.empty_like(x)
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_bytes(b * n, dim), dtype=torch.uint8,
                          device=x.device)
    p = common.ptr
    common.launch("nvt_fused_ln_qkv_f32_bwd",
                  (common.VOID,) * 8 + (common.INT,) * 3 + (common.FLOAT,),
                  x, p(dqkv), p(x), p(gamma), p(w), p(dx), p(dgb[0]),
                  p(dgb[1]), p(scratch), b * n, dim, inner, nn.LN_EPS)
    return dx, dgb[0], dgb[1]


def f32_operands(b: int, dim: int = DIM, inner: int = INNER, seed: int = 42
                 ) -> tuple:
    """K7's operands at f32, as chip_smoke.py's (d) makes them: (dqkv, x,
    gamma, w), standard normal dqkv and x, gamma near 1, Wqkv in
    nn.Linear's default range."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    w = rng.uniform(-1, 1, (3 * inner, dim)) / dim ** 0.5
    return (t(b, N, 3 * inner), t(b, N, dim), t(dim, scale=0.1, offset=1.0),
            torch.tensor(w, dtype=torch.float32, device="cuda"))


def run_f32(b: int, iters: int) -> list:
    """Lines of K7 f32 at batch b beside f32 torch.mm at its GEMM."""
    args = f32_operands(b)
    m = b * N
    dqkv2, w = args[0].reshape(m, 3 * INNER), args[3]
    mm = {f"du [{m}, {3 * INNER}] x [{3 * INNER}, {DIM}]":
          lambda: torch.mm(dqkv2, w)}
    what = f"K7 f32 batch {b} (M {m}, dim {DIM}, inner {INNER})"
    return k4_times.f32_lines(what, lambda: k7_f32_call(*args),
                              {"du": 2 * m * 3 * INNER * DIM}, mm, iters,
                              short=f32_short)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default=None,
                    help="time only the bf16 K7, or only K7 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_qkv_bwd_device_times: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.other:
        use_checkout(os.path.abspath(args.other))
        print(f"kernels of {args.other}")
    if args.only != "f32":
        for b in (1, 8, 32, 128):
            ops = operands(b)
            what = (f"K7 batch {b} (M {b * N}, dim {DIM}, inner {INNER})")
            print(line(what, measure(ops, args.iters), b * N), flush=True)
            for shape, dev in yardstick(b * N, DIM, INNER,
                                        args.iters).items():
                print(f"  K17 bf16 {shape}: " + (", ".join(
                    f"{k} {us:.1f} us" for k, us in dev.items()) or
                    "device not measured (no kernels traced)"), flush=True)
            del ops
    if args.only != "bf16":
        for b in k4_times.F32_BATCHES:
            for text in run_f32(b, args.iters):
                print(text, flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
