"""How near does the port's int8 path get to the card's int8 rate?

The PyTorch port of ``scripts/int8_pallas_bench.py``: the same tiled GEMM
(K17, ``ops/int8_gemm.py``), once with int8 operands (int32 sums) and once
with bf16 (f32 sums), and the int8 GEMM with the serving epilogue (K18,
per-row and per-column scales to bf16), at the flagship serving GEMM
shapes and a square diagnostic. Each line gives ms and TFLOP/s or TOP/s of
the three, int8/bf16 and dq/bf16, and, as library references, a bf16
``torch.matmul`` (bf16 out), ``torch.mm(..., out_dtype=torch.float32)``
where this PyTorch has it (f32 out, as K17 bf16 writes) and
``torch._int_mm`` (int8 -> int32) on the same operands. On the card each
time is the median of CUDA-event timings of one call after a warm-up (the
TPU script's two-point chain fit only cancelled its host round trip), so a
call whose enqueue takes longer than its kernels reads the host's time;
``scripts/torch_gemm_device_times.py`` reads the device's own.
``--device cpu`` runs the plain versions on the host clock.

    python scripts/torch_int8_gemm_bench.py [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.ops import int8_gemm as k17  # noqa: E402

# (name, M, K, N), as scripts/int8_pallas_bench.py:125-131.
SHAPES = [("fc1", 8192, 1024, 2048),
          ("fc2", 8192, 2048, 1024),
          ("qkv", 8192, 1024, 1536),
          ("attn_qk", 8192, 64, 1024),
          ("attn_pv", 8192, 1024, 64),
          ("patch_embed", 8192, 768, 1024),
          ("square4k", 4096, 4096, 4096)]


def median_ms(fn, device: str, iters: int) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` timings after two
    warm-up calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def operands(m: int, k: int, n: int, device: str, seed: int = 0) -> dict:
    """The script's operands: int8 codes in [-127, 127], normal bf16 values
    and scales in [0.5, 1.5), from one seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return {
        "a8": torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8,
                           device=device),
        "b8": torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8,
                           device=device),
        "abf": torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16,
                            device=device),
        "bbf": torch.tensor(rng.standard_normal((k, n)), dtype=torch.bfloat16,
                            device=device),
        "sa": torch.tensor(rng.random((m, 1)) + 0.5, dtype=torch.float32,
                           device=device),
        "sb": torch.tensor(rng.random((1, n)) + 0.5, dtype=torch.float32,
                           device=device),
    }


def library_int_mm(a8: torch.Tensor, b8: torch.Tensor):
    """``torch._int_mm`` on these operands where this build takes them (on
    CUDA), else None: a yardstick only, so a refusal leaves its column
    empty."""
    if a8.device.type != "cuda" or not hasattr(torch, "_int_mm"):
        return None
    try:
        torch._int_mm(a8, b8)
    except RuntimeError as err:
        print(f"torch._int_mm refuses [{a8.shape[0]}, {a8.shape[1]}] x "
              f"[{b8.shape[0]}, {b8.shape[1]}]: {err}", file=sys.stderr)
        return None
    return lambda: torch._int_mm(a8, b8)


def library_mm_f32(a: torch.Tensor, b: torch.Tensor):
    """``torch.mm(a, b, out_dtype=torch.float32)`` on these bf16 operands
    where this build has it (on CUDA), else None: a yardstick only."""
    if a.device.type != "cuda":
        return None
    try:
        torch.mm(a, b, out_dtype=torch.float32)
    except (RuntimeError, TypeError) as err:
        print(f"torch.mm(out_dtype=torch.float32) refuses [{a.shape[0]}, "
              f"{a.shape[1]}] x [{b.shape[0]}, {b.shape[1]}]: {err}",
              file=sys.stderr)
        return None
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def run(device: str = "cuda", shapes=SHAPES, iters: int = 20) -> list:
    """One dict per shape: the ms of K17 bf16, K17 int8, K18 and the
    library calls (None where there is none)."""
    rows = []
    for name, m, k, n in shapes:
        ops = operands(m, k, n, device)
        a8, b8 = ops["a8"], ops["b8"]
        row = {"name": name, "m": m, "k": k, "n": n,
               "bf16": median_ms(lambda: k17.blocked_matmul(
                   ops["abf"], ops["bbf"]), device, iters),
               "int8": median_ms(lambda: k17.blocked_matmul(a8, b8), device,
                                 iters),
               "dq": median_ms(lambda: k17.dynquant_matmul(
                   a8, b8, ops["sa"], ops["sb"]), device, iters),
               "matmul": median_ms(lambda: torch.matmul(
                   ops["abf"], ops["bbf"]), device, iters)}
        for key, fn in (("int_mm", library_int_mm(a8, b8)),
                        ("mm_f32", library_mm_f32(ops["abf"], ops["bbf"]))):
            row[key] = median_ms(fn, device, iters) if fn is not None else None
        rows.append(row)
    return rows


def line(row: dict) -> str:
    """The JAX script's columns, then the library references."""
    flops = 2.0 * row["m"] * row["k"] * row["n"]

    def rate(ms):
        return flops / (ms * 1e-3) / 1e12

    def lib(key, unit):
        ms = row[key]
        return ("n/a" if ms is None
                else f"{ms:7.3f} ms ({rate(ms):6.1f} {unit})")

    return (f"{row['name']:11s} bf16 {row['bf16']:7.3f} ms "
            f"({rate(row['bf16']):6.1f} TF/s) | int8 {row['int8']:7.3f} ms "
            f"({rate(row['int8']):6.1f} TOP/s) | dynquant {row['dq']:7.3f} ms "
            f"({rate(row['dq']):6.1f} TOP/s) | int8/bf16 "
            f"{row['bf16'] / row['int8']:4.2f}x dq/bf16 "
            f"{row['bf16'] / row['dq']:4.2f}x | "
            f"library: matmul bf16 {lib('matmul', 'TF/s')}, mm f32 out "
            f"{lib('mm_f32', 'TF/s')}, _int_mm {lib('int_mm', 'TOP/s')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="fc1 and square4k only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_int8_gemm_bench: CUDA is not available (--device cpu "
              "runs the plain versions)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"device: {where}")
    shapes = SHAPES[:1] + SHAPES[-1:] if args.quick else SHAPES
    for row in run(args.device, shapes, args.iters):
        print(line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
