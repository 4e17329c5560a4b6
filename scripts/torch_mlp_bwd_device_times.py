"""Device-only times of K9, the bf16 residual MLP's data-grad backward,
pass by pass, beside K17 bf16 at its two GEMM shapes.

``chip_smoke.py`` times a K9 call with CUDA events around it, which also
counts the wrapper's enqueue (six tensor maps, five launches). This script
reads the device's own kernel times from ``torch.profiler``: for the
flagship block (dim 1024, MLP 2048) at batch 1, 8, 32 and 128 (the train
step's) x 1001 tokens, each of K9's five passes (dz rows, the hidden GEMM,
the du GEMM, the LayerNorm backward rows, the column sums), their sum and
the host's enqueue time per call, as the train step calls it (dropout 0.1)
and as Grad-CAM does (dropout 0); then, as the yardstick of the two GEMM passes, K17 bf16's
GEMM kernel (and its transpose step, apart) at da's [M, dim] x [dim, hid]
and du's [M, hid] x [hid, dim], M the batch-8 rows rounded up to 16,
which K17 needs.

K9 at f32 (with ``--only f32``, or after the rest): at batch 8 and 32,
dropout 0.1 (the train step's) and 0 (Grad-CAM's), on chip_smoke.py's f32
operands: each pass's device time (``wsplit``, the weight pre-pass on W2
and W1 together; ``dz_rows``; the two GEMMs ``hidden`` and ``du``;
``ln_bwd``; ``colsum``; an older checkout's FFMA GEMMs show under the same
names), their sum and the one-call CUDA-event time, each GEMM's rate in
TFLOP/s (2 M dim hid flops) and share of the 3xTF32 bound (165 TFLOP/s),
beside f32 ``torch.mm`` at the hidden GEMM's [M, dim] x [dim, hid] and the
du GEMM's [M, hid] x [hid, dim] (``allow_tf32`` off, PyTorch's default)
and the factor between the two. ``--other <checkout>`` routes every
kernel call to another checkout's kernel library (built there): K9 f32
goes through :func:`k9_f32_call`, which hands an older
``nvt_fused_mlp_f32_bwd`` (the FFMA design, no pre-pass) W1 and W2
themselves.

    python scripts/torch_mlp_bwd_device_times.py [--iters 20]
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gemm_device_times as gemm_times  # noqa: E402
import torch_mlp_device_times as k4_times  # noqa: E402
from torch_attention_device_times import use_checkout  # noqa: E402

N, DIM, HID = k4_times.N, k4_times.DIM, k4_times.HID
PASSES = ("dz_rows", "hidden", "du_kernel", "ln_bwd", "colsum")
TRAIN = {"dropout_rate": 0.1, "seeds": (1235, 1236)}
# The f32 backwards' kernels as the profiler names them -> the pass: this
# design's, then an older checkout's FFMA hidden GEMM by its epilogue.
F32_PASSES = (("split_t_kernel", "wsplit"), ("dz_rows", "dz_rows"),
              ("row_stats", "row_stats"), ("hidden_kernel", "hidden"),
              ("HiddenEpi", "hidden"), ("ln_du_kernel", "du"),
              ("ln_bwd_kernel", "ln_bwd"), ("colsum", "colsum"))


def operands(b: int, dim: int = DIM, hid: int = HID, seed: int = 42
             ) -> tuple:
    """K9's operands for x [b, N, dim]: (dy, x, h, gamma, beta, w1, w2),
    made as chip_smoke.py's kernel phase makes them (K4's operands, h from
    K4's own forward at dropout 0.1, dy standard normal times 0.1)."""
    x, gamma, beta, w1, b1, w2, b2 = k4_times.operands(b, dim, hid, seed)
    _, h = fused_mlp.fused_mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2,
                                          **k4_times.TRAIN)
    rng = np.random.default_rng(seed + 1)
    dy = torch.tensor(0.1 * rng.standard_normal(tuple(x.shape)),
                      dtype=torch.bfloat16, device="cuda")
    return dy, x, h, gamma, beta, w1, w2


def short(name: str) -> str:
    for key in PASSES + ("transpose_kernel", "gemm_kernel"):
        if key in name:
            return key
    return name[:48]


def measure(args: tuple, iters: int, **kw) -> dict:
    """Device microseconds of each pass of one K9 call on ``args`` (with
    the keywords ``kw``), their sum in ms ({} and None where the trace held
    no kernels), and the host's enqueue microseconds a call."""
    call = lambda: fused_mlp.fused_mlp_bwd_cuda(*args, **kw)  # noqa: E731
    dev = gemm_times.device_us(call, iters)
    passes = {}
    for key, us in dev.items():
        passes[short(key)] = passes.get(short(key), 0.0) + us
    return {"passes_us": passes,
            "device_ms": sum(passes.values()) / 1e3 if passes else None,
            "enqueue_us": gemm_times.enqueue_us(call, 4 * iters)}


def yardstick(m: int, dim: int, hid: int, iters: int) -> dict:
    """K17 bf16 at the hidden GEMM's [m, dim] x [dim, hid] and the du
    GEMM's [m, hid] x [hid, dim]: {shape: {kernel: device us}}."""
    return {key.replace("fc1", "da").replace("fc2", "du"): dev
            for key, dev in k4_times.yardstick(m, dim, hid, iters).items()}


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


def scratch_bytes(m: int, dim: int) -> int:
    """The scratch of a K9 or K7 f32 call as the library behind the
    wrappers counts it (``nvt_ln_bwd_f32_scratch_bytes``)."""
    import ctypes

    fn = _build.library().nvt_ln_bwd_f32_scratch_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2
    return int(fn(m, dim))


def k9_f32_call(args: tuple, dropout_rate: float = 0.0, seeds=(0, 0)):
    """K9 at f32 on the library behind the wrappers: this checkout's
    wrapper where the library's K9 f32 runs on the 3xTF32 Loop
    (``nvt_fused_mlp_f32_bwd_smem_bytes``); else an older
    ``nvt_fused_mlp_f32_bwd``, which takes W1 and W2 themselves. (dx, u,
    a, dz, dh, dgamma, dbeta)."""
    if hasattr(_build.library(), "nvt_fused_mlp_f32_bwd_smem_bytes"):
        return fused_mlp.fused_mlp_bwd_f32_cuda(
            *args, dropout_rate=dropout_rate, seeds=seeds)
    dy, x, h, gamma, beta, w1, w2 = args
    b, n, dim = x.shape
    hid = w1.shape[0]
    m = b * n
    inv_keep, keep_q = common.dropout_args(dropout_rate)
    dx, u = torch.empty_like(x), torch.empty_like(x)
    dz = torch.empty_like(dy) if keep_q else None
    a, dh = (x.new_empty(m, hid) for _ in range(2))
    dgb = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_bytes(m, dim), dtype=torch.uint8,
                          device=x.device)
    p = common.ptr
    common.launch("nvt_fused_mlp_f32_bwd",
                  (common.VOID,) * 15 + (common.INT,) * 3
                  + (common.FLOAT, common.FLOAT, common.INT, common.U64,
                     common.U64), x, p(dy), p(x), p(h), p(gamma), p(beta),
                  p(w1), p(w2), p(dx), p(u), p(a), p(dz), p(dh), p(dgb[0]),
                  p(dgb[1]), p(scratch), m, dim, hid, nn.LN_EPS, inv_keep,
                  keep_q, int(seeds[0]), int(seeds[1]))
    return (dx, u.reshape(m, dim), a, (dy if dz is None else dz).reshape(
        m, dim), dh, dgb[0], dgb[1])


def f32_operands(b: int, dim: int = DIM, hid: int = HID, seed: int = 42
                 ) -> tuple:
    """K9's operands at f32 for x [b, N, dim], as chip_smoke.py's (d) makes
    them: (dy, x, h, gamma, beta, w1, w2), standard normal activations,
    LN affines near (1, 0), weights in nn.Linear's default range."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w(out_f, in_f):
        return torch.tensor(rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
                            dtype=torch.float32, device="cuda")

    return (t(b, N, dim), t(b, N, dim), t(b, N, hid),
            t(dim, scale=0.1, offset=1.0), t(dim, scale=0.1), w(hid, dim),
            w(dim, hid))


def run_f32(b: int, iters: int) -> list:
    """Lines of K9 f32 at batch b, dropout 0.1 and 0, beside f32 torch.mm
    at its two GEMMs."""
    args = f32_operands(b)
    m = b * N
    dy2, dh2 = args[0].reshape(m, DIM), args[2].reshape(m, HID)
    w1, w2 = args[5], args[6]
    gemm_flop = {"hidden": 2 * m * DIM * HID, "du": 2 * m * DIM * HID}
    mm = {f"hidden [{m}, {DIM}] x [{DIM}, {HID}]": lambda: torch.mm(dy2, w2),
          f"du [{m}, {HID}] x [{HID}, {DIM}]": lambda: torch.mm(dh2, w1)}
    lines = []
    for rate in (0.1, 0.0):
        kw = dict(dropout_rate=rate, seeds=(1235, 1236))
        what = (f"K9 f32 batch {b} (M {m}, dim {DIM}, mlp {HID}) dropout "
                f"{rate}")
        lines += k4_times.f32_lines(what, lambda: k9_f32_call(args, **kw),
                                    gemm_flop, mm if not rate else {},
                                    iters, short=f32_short)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("bf16", "f32"), default=None,
                    help="time only the bf16 K9, or only K9 at f32")
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mlp_bwd_device_times: needs the card", file=sys.stderr)
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
        for b in k4_times.F32_BATCHES:
            for text in run_f32(b, args.iters):
                print(text, flush=True)
            torch.cuda.empty_cache()
    return 0


def bf16(iters: int) -> None:
    """The bf16 K9's lines at batch 1, 8, 32 and 128, then K17 bf16's."""
    for b in (1, 8, 32, 128):
        ops = operands(b)
        what = f"K9 batch {b} (M {b * N}, dim {DIM}, mlp {HID})"
        print(line(what + " dropout 0.1", measure(ops, iters, **TRAIN)),
              flush=True)
        print(line(what + " dropout 0", measure(ops, iters)), flush=True)
        del ops
    for shape, dev in yardstick(8 * N, DIM, HID, iters).items():
        print(f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)"), flush=True)


if __name__ == "__main__":
    sys.exit(main())
