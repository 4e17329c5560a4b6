"""Device-only times of K4, the residual MLP forward, pass by pass: bf16
beside K17 bf16 at its two GEMM shapes, and f32 beside f32 ``torch.mm``.

``chip_smoke.py`` times a K4 call with CUDA events around it, which also
counts the wrapper's enqueue (four tensor maps, three launches). This
script reads the device's own kernel times from ``torch.profiler``: for
the flagship block (dim 1024, MLP 2048) at batch 1, 8 and 32 x 1001
tokens, each of K4's three passes (LN rows, fc1 + GELU, fc2 + residual),
their sum and the host's enqueue time per call, serving (dropout 0, no h)
and as the train step calls it (dropout 0.1, h stored); then, as the
yardstick of the two GEMM passes, K17 bf16's GEMM kernel (and its
transpose step, apart) at [M, dim] x [dim, hid] and [M, hid] x [hid, dim],
M the batch-8 rows rounded up to 16, which K17 needs.

K4 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32,
dropout 0 and 0.1 with h, on chip_smoke.py's f32 operands: each pass's
device time (the weight pre-pass ``split`` on W1 and W2 together,
``ln_rows``, and the two GEMMs ``fc1_gelu`` and ``fc2_residual``; an
older checkout's FFMA GEMMs show under the same names), their sum and the
one-call CUDA-event time, each GEMM's rate in TFLOP/s (2 M dim hid flops)
and share of the 3xTF32 bound (165 TFLOP/s), beside f32 ``torch.mm`` at
fc1's [M, dim] x [dim, hid] and fc2's [M, hid] x [hid, dim] (device time
of its kernels and events; ``torch.backends.cuda.matmul.allow_tf32`` off,
PyTorch's default) and the factor between the two. ``--other <checkout>``
routes every kernel call to another checkout's kernel library (built
there): K4 f32 goes through :func:`k4_f32_call`, which hands an older
``nvt_fused_mlp_f32_fwd`` (the FFMA design, no pre-pass) W1 and W2
themselves.

    python scripts/torch_mlp_device_times.py [--iters 20]
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
from neurovit_tpu_torch.ops import _build, common, fused_mlp  # noqa: E402
from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gemm_device_times as gemm_times  # noqa: E402
from torch_attention_device_times import (events_ms,  # noqa: E402
                                          use_checkout)

N, DIM, HID = 1001, 1024, 2048
PASSES = ("ln_rows", "fc1_gelu", "fc2_residual")
TRAIN = {"dropout_rate": 0.1, "seeds": (1235, 1236), "return_h": True}
F32_BATCHES = (8, 32)
TF32X3_PER_S = 165e12
# The f32 forwards' kernels as the profiler names them -> the pass: this
# design's, then an older checkout's FFMA GEMMs by their epilogue.
F32_PASSES = (("split_kernel", "split"), ("ln_rows", "ln_rows"),
              ("fc1_gelu", "fc1_gelu"), ("fc2_residual", "fc2_residual"),
              ("qkv_gemm", "qkv_gemm"), ("GeluEpi", "fc1_gelu"),
              ("ResidualEpi", "fc2_residual"), ("QkvEpi", "qkv_gemm"))


def operands(b: int, dim: int = DIM, hid: int = HID, seed: int = 42
             ) -> tuple:
    """K4's operands for x [b, N, dim], made as chip_smoke.py's kernel
    phase makes them: standard normal x, LN affines near (1, 0), bf16
    weights in nn.Linear's default range, small biases."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    def w(out_f, in_f):
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.bfloat16, device="cuda")

    return (t(b, N, dim), t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim, scale=0.1, dtype=torch.float32), w(hid, dim),
            t(hid, scale=0.03, dtype=torch.float32), w(dim, hid),
            t(dim, scale=0.02, dtype=torch.float32))


def short(name: str) -> str:
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int, **kw) -> dict:
    """Device microseconds of each pass of one K4 call on ``args`` (with
    the keywords ``kw``), their sum in ms ({} and None where the trace held
    no kernels), and the host's enqueue microseconds a call."""
    call = lambda: fused_mlp.fused_mlp_block_cuda(*args, **kw)  # noqa: E731
    dev = gemm_times.device_us(call, iters)
    passes = {}
    for key, us in dev.items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "enqueue_us": gemm_times.enqueue_us(call, 4 * iters)}


def yardstick(m: int, dim: int, hid: int, iters: int) -> dict:
    """K17 bf16 at fc1's [m, dim] x [dim, hid] and fc2's [m, hid] x [hid,
    dim] (m rounded up to 16): {shape: {kernel: device us}}."""
    m16 = -(-m // 16) * 16
    rng = np.random.default_rng(0)
    out = {}
    for name, k, n in (("fc1", dim, hid), ("fc2", hid, dim)):
        a = torch.tensor(rng.standard_normal((m16, k)), dtype=torch.bfloat16,
                         device="cuda")
        b = torch.tensor(rng.standard_normal((k, n)) * k ** -0.5,
                         dtype=torch.bfloat16, device="cuda")
        dev = gemm_times.device_us(lambda: k17.gemm_bf16_cuda(a, b), iters)
        out[f"{name} [{m16}, {k}] x [{k}, {n}]"] = {
            short(key): us for key, us in dev.items()}
    return out


def line(what: str, m: dict) -> str:
    if not m["passes_us"]:
        return f"{what}: device not measured (no kernels traced)"
    parts = ", ".join(f"{p} {m['passes_us'].get(p, 0.0):.1f}"
                      for p in PASSES)
    return (f"{what}: device {m['device_ms']:.4f} ms ({parts} us); enqueue "
            f"{m['enqueue_us']:.1f} us a call")


def f32_short(name: str) -> str:
    for key, label in F32_PASSES:
        if key in name:
            return label
    return name[:48]


def k4_f32_call(args: tuple, dropout_rate: float = 0.0, seeds=(0, 0),
                return_h: bool = False):
    """K4 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library has the forwards' weight pre-pass
    (``nvt_split_f32``); else an older ``nvt_fused_mlp_f32_fwd``, which
    takes W1 and W2 themselves. y, and h with ``return_h``."""
    if hasattr(_build.library(), "nvt_split_f32"):
        return fused_mlp.fused_mlp_block_f32_cuda(
            *args, dropout_rate=dropout_rate, seeds=seeds, return_h=return_h)
    x, gamma, beta, w1, b1, w2, b2 = args
    b, n, dim = x.shape
    hid = w1.shape[0]
    inv_keep, keep_q = common.dropout_args(dropout_rate)
    y = torch.empty_like(x)
    h = x.new_empty(b, n, hid) if return_h else None
    scratch = torch.empty(fused_mlp.mlp_f32_plan(b * n, dim, hid)
                          .scratch_bytes, dtype=torch.uint8, device=x.device)
    p = common.ptr
    common.launch("nvt_fused_mlp_f32_fwd",
                  (common.VOID,) * 10 + (common.INT,) * 3
                  + (common.FLOAT, common.FLOAT, common.INT, common.U64,
                     common.U64), x, p(x), p(gamma), p(beta), p(w1), p(b1),
                  p(w2), p(b2), p(y), p(h), p(scratch), b * n, dim, hid,
                  nn.LN_EPS, inv_keep, keep_q, int(seeds[0]), int(seeds[1]))
    return (y, h) if return_h else y


def f32_lines(what: str, call, gemm_flop: dict, mm: dict, iters: int,
              short=f32_short) -> list:
    """Lines of an f32 ``call`` (K4 or K2; K9 or K7 with their ``short``):
    each pass's device time (kernels named by ``short``), their sum and
    the one-call events; each GEMM pass named in ``gemm_flop`` (its flops)
    with its rate and share of the 3xTF32 bound; then each f32 torch.mm of
    ``mm`` (name -> call) at the same shape, device time and events, and
    the factor between the two."""
    passes = {}
    for key, us in gemm_times.device_us(call, iters).items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    device_ms = sum(passes.values()) / 1e3 if passes else None
    events = events_ms(call)
    flop = sum(gemm_flop.values())
    bound_ms = flop / TF32X3_PER_S * 1e3
    head = f"{what}: "
    if passes:
        head += (f"device {device_ms:.4f} ms (" + ", ".join(
            f"{p} {us:.1f}" for p, us in passes.items()) + " us)")
    else:
        head += "device not measured (no kernels traced)"
    for name, f in gemm_flop.items():
        us = passes.get(name)
        if us:
            head += (f"; {name} {f / us / 1e6:.1f} TFLOP/s, "
                     f"{f / TF32X3_PER_S * 1e6 / us:.3f} of its 3xTF32 "
                     "bound")
    head += (f"; events {events:.4f} ms; 3xTF32 bound {bound_ms:.4f} ms "
             f"({flop / 1e9:.2f} GFLOP)")
    lines = [head]
    mm_dev, mm_events = 0.0, 0.0
    for name, fn in mm.items():
        dev = gemm_times.device_us(fn, iters)
        ms = events_ms(fn)
        mm_events += ms
        mm_dev = None if not dev or mm_dev is None else (
            mm_dev + sum(dev.values()) / 1e3)
        kernels = "; ".join(f"{k[:60]} {v:.1f} us" for k, v in dev.items())
        lines.append(f"  f32 torch.mm {name}: device " + (
            f"{sum(dev.values()) / 1e3:.4f} ms ({kernels})" if dev
            else "not measured") + f", events {ms:.4f} ms")
    if device_ms and mm_dev:
        lines.append(f"  {what.split(' batch')[0]} / f32 torch.mm: device "
                     f"{device_ms / mm_dev:.3f} ({mm_dev:.4f} ms), events "
                     f"{events / mm_events:.3f} ({mm_events:.4f} ms)")
    return lines


def f32_operands(b: int, dim: int = DIM, hid: int = HID,
                 seed: int = 42) -> tuple:
    """K4's operands at f32 for x [b, N, dim], as chip_smoke.py's f32
    phase makes them."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w(out_f, in_f):
        return torch.tensor(rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
                            dtype=torch.float32, device="cuda")

    return (t(b, N, dim), t(dim, scale=0.1, offset=1.0), t(dim, scale=0.1),
            w(hid, dim), t(hid, scale=0.03), w(dim, hid),
            t(dim, scale=0.02))


def run_f32(b: int, iters: int) -> list:
    """Lines of K4 f32 at batch b, dropout 0 and 0.1 with h, beside f32
    torch.mm at fc1 and fc2."""
    args = f32_operands(b)
    m = b * N
    x2 = args[0].reshape(m, DIM)
    g2 = torch.randn(m, HID, device="cuda")
    w1, w2 = args[3], args[5]
    gemm_flop = {"fc1_gelu": 2 * m * DIM * HID, "fc2_residual": 2 * m * DIM
                 * HID}
    mm = {f"fc1 [{m}, {DIM}] x [{DIM}, {HID}]": lambda: torch.mm(x2, w1.t()),
          f"fc2 [{m}, {HID}] x [{HID}, {DIM}]": lambda: torch.mm(g2, w2.t())}
    lines = []
    for rate in (0.0, 0.1):
        kw = dict(dropout_rate=rate, seeds=(1235, 1236), return_h=bool(rate))
        what = (f"K4 f32 batch {b} (M {m}, dim {DIM}, mlp {HID}) dropout "
                f"{rate}" + (" with h" if rate else ""))
        lines += f32_lines(what, lambda: k4_f32_call(args, **kw), gemm_flop,
                           mm if not rate else {}, iters)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default=None,
                    help="time only the bf16 K4, or only K4 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mlp_device_times: needs the card", file=sys.stderr)
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
    """The bf16 K4's lines at batch 1, 8 and 32, then K17 bf16's."""
    for b in (1, 8, 32):
        ops = operands(b)
        what = f"K4 batch {b} (M {b * N}, dim {DIM}, mlp {HID})"
        print(line(what, measure(ops, iters)), flush=True)
        print(line(what + " dropout 0.1 with h",
                   measure(ops, iters, **TRAIN)), flush=True)
        del ops
    for shape, dev in yardstick(8 * N, DIM, HID, iters).items():
        print(f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)"), flush=True)


if __name__ == "__main__":
    sys.exit(main())
