#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (neurovit_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:

1. device      nvidia-smi's name and power limit, torch's device name
2. build       compile the kernels from neurovit_tpu_torch/csrc
3. kernels     each kernel against its plain PyTorch version on the card, at
               the flagship shapes (batch 8 x 1001 tokens), with CUDA-event
               timings of both: the forwards K1-K4 at dropout 0, K1, K3 and
               K4 again at dropout 0.1 (the same mask bits on both sides),
               the backwards K5, K7, K8, K9 at dropout 0 and 0.1, K6 (the
               [B, H, N, D] attention) forward at n_valid 1001 and 900 and
               at dropout 0.1 and backward at dropout 0 and 0.1, each also
               timed beside K1 or K5 on the transposed inputs, and the int8
               kernels K10-K13 (K13 also at n_valid 900), each timed beside
               its bf16 counterpart (K2, K3, K4, K1) on the same inputs
4. slice       the flagship model (configs/config.yaml, seed 42) saved with
               torch.save, served by Predictor.from_checkpoint on cuda:
               warmup, then requests of 1, 3 and 32 volumes; checked against
               single-volume calls and against the same model on the CPU
5. http        the HTTP server on an ephemeral port: /healthz, then /predict
               with three NIfTI files, two of them posted concurrently;
               every forward kernel launched depth times per forward of 4-5
6. int8        the same checkpoint served with quant="int8": warmup,
               requests of 1, 3 and 32 volumes against single calls and
               against the quantized model on the CPU plain path; against
               the bf16 Predictor within 0.05; /healthz says "int8" and one
               /predict equals Predictor; K10-K13 launched depth times per
               forward and K1-K4 never; one forward with SERVING_INT8_ATTN
               off runs K1 in place of K13
7. rate        the int8 and the bf16 forward at batch 32, device-only by
               CUDA events, and a profiler split of the int8 forward
8. gradcam     Grad-CAM of the same checkpoint with its LayerNorm affines
               moved off their init: the launch counts of one
               get_attention_map of 4 volumes (K1-K3 depth - 1 times, K4
               depth times, K6 forward and backward and K9 once, no other
               backward kernel); probe gradients and raw CAMs of the batch
               against single volumes and one volume against the CPU plain
               path; every menu method, integrated gradients, Kernel SHAP
               and grad x input once; the driver's get_sample_gradcam with
               the map written as NIfTI and read back; Grad-CAM latency at
               batch 1 and 8 by CUDA events, each with a profiler split
9. grad        the flagship at batch 2, dropout 0.1: loss and every
               parameter's gradient on cuda against the CPU plain path
10. train      Trainer.run() for one epoch of seeded 90^3 volumes (batch 32,
               8 train and 2 val batches); its checkpoint served by
               Predictor; then 10 steps on one fixed batch at dropout 0
11. train_rate train steps at batch 128: median step time, vol/s, TFLOP/s,
               peak memory, and a profiler split of one step
12. counts     in phase 10, every bf16 forward kernel launched depth times
               per forward and every backward kernel depth times per
               backward

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, the script exits
non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 42
# Kernel phase shapes: the flagship block at batch 8.
B, N, DIM, HEADS, DIM_HEAD, MLP = 8, 1001, 1024, 8, 64, 2048
N_VALID_MASKED = 900
# bf16 tolerance, elementwise: |kernel - plain| <= ATOL + RTOL * |plain|.
# The two sides round at the same points; they differ only where an f32
# sum taken in another order lands on the other side of a bf16 rounding
# boundary, which moves a value by one bf16 ulp (2^-8 to 2^-7 relative).
ATOL, RTOL = 1e-2, 2.0 ** -6
# Backward data gradients, elementwise: |kernel - plain| <= BWD_ATOL +
# BWD_FRAC * max|plain| + RTOL * |plain|. Both sides round ds, dz and dh to
# bf16 at the same points; an ulp of such an intermediate moves a sum of
# ~1000 terms. dgamma / dbeta: relative Frobenius error <= PARAM_RTOL.
BWD_ATOL, BWD_FRAC, PARAM_RTOL = 1e-4, 2e-2, 1e-2
# The int8 kernels K10-K13 take the same elementwise ATOL + RTOL * |plain|:
# their int32 products are exact on both sides, and an f32 LayerNorm, GELU,
# score or denominator sum taken in another order may move one int8 code by
# one step (a change far below ATOL) or an output by one bf16 ulp.
# Probabilities from different batch buckets, from HTTP and from the CPU
# plain path: the same rounding points, six layers deep.
PROB_ATOL = 2e-2
# int8 against bf16 serving on the same weights: the JAX test's bound
# (tests/test_int8_serving.py:205).
INT8_ATOL = 5e-2
# Full-model gradients, cuda against the CPU plain path: relative Frobenius
# error per parameter (bf16 through six blocks and back). Grad-CAM probe
# gradients and raw CAMs take the same bound, against the CPU plain path and
# batched against single volumes.
GRAD_RTOL = 2e-2
DROPOUT = 0.1
# Train FLOP per volume and step, from the shapes (PERF.md): 89.4 GFLOP
# forward; the backward doubles every GEMM and attention's backward is 2.5x
# its forward (flash_attention.py:434).
TRAIN_GFLOP_PER_VOL = 3 * 89.4 + 6 * 0.5 * 2.05

KERNELS = [
    # (name, source, replaces)
    ("flash_attention", "neurovit_tpu_torch/csrc/flash_attention.cu",
     "neurovit_tpu/ops/flash_attention.py:233"),
    ("fused_ln_qkv", "neurovit_tpu_torch/csrc/fused_qkv.cu",
     "neurovit_tpu/ops/fused_qkv.py:57"),
    ("fused_outproj_residual", "neurovit_tpu_torch/csrc/fused_outproj.cu",
     "neurovit_tpu/ops/fused_outproj.py:44"),
    ("fused_mlp_block", "neurovit_tpu_torch/csrc/fused_mlp.cu",
     "neurovit_tpu/ops/fused_mlp.py:108"),
    ("flash_attention_bwd", "neurovit_tpu_torch/csrc/flash_attention_bwd.cu",
     "neurovit_tpu/ops/flash_attention.py:269"),
    ("fused_ln_qkv_bwd", "neurovit_tpu_torch/csrc/fused_qkv_bwd.cu",
     "neurovit_tpu/ops/fused_qkv.py:71"),
    ("fused_outproj_bwd", "neurovit_tpu_torch/csrc/fused_outproj_bwd.cu",
     "neurovit_tpu/ops/fused_outproj.py:56"),
    ("fused_mlp_bwd", "neurovit_tpu_torch/csrc/fused_mlp_bwd.cu",
     "neurovit_tpu/ops/fused_mlp.py:141"),
    ("flash_attention_bhnd", "neurovit_tpu_torch/csrc/flash_attention.cu",
     "neurovit_tpu/ops/flash_attention.py:91"),
    ("flash_attention_bhnd_bwd",
     "neurovit_tpu_torch/csrc/flash_attention_bwd.cu",
     "neurovit_tpu/ops/flash_attention.py:152"),
    ("int8_ln_qkv", "neurovit_tpu_torch/csrc/int8_qkv.cu",
     "neurovit_tpu/ops/int8_serving.py:154"),
    ("int8_outproj_residual", "neurovit_tpu_torch/csrc/int8_outproj.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_mlp_block", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:173"),
    ("int8_flash_attention", "neurovit_tpu_torch/csrc/int8_attention.cu",
     "neurovit_tpu/ops/int8_serving.py:286"),
]
INT8_KERNELS = [name for name, _, _ in KERNELS if name.startswith("int8_")]
# K6: only the Grad-CAM probe's last block runs it.
GRADCAM_KERNELS = ["flash_attention_bhnd", "flash_attention_bhnd_bwd"]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event timings."""
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


def compare(name: str, got, want, grads: bool = False,
            params=()) -> tuple:
    """Elementwise check of every output (``grads``: the backward's
    tolerance); outputs at the indices ``params`` are parameter gradients,
    checked by relative Frobenius error."""
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    max_abs, max_rel = 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().reshape(w.shape), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel output {i} is not finite")
        diff = (g - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel, float(diff.max() / w.abs().max().clamp_min(
            1e-30)))
        if i in params:
            err = float((g - w).norm() / w.norm().clamp_min(1e-30))
            if err > PARAM_RTOL:
                raise AssertionError(f"{name}: output {i} relative Frobenius "
                                     f"error {err:.3e} > {PARAM_RTOL}")
            continue
        tol = ((BWD_ATOL + BWD_FRAC * w.abs().max()) if grads else ATOL) + \
            RTOL * w.abs()
        bad = diff > tol
        if bad.any():
            raise AssertionError(
                f"{name}: output {i}: {int(bad.sum())} elements outside the "
                f"tolerance (max abs err {float(diff.max()):.3e})")
    return max_abs, max_rel


def kernel_phase(card: str) -> dict:
    from neurovit_tpu_torch.ops import (flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv,
                                        int8_serving)

    rng = np.random.default_rng(SEED)
    dev = "cuda"

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device=dev)

    def w(out_f, in_f, dtype=torch.float32):   # nn.Linear's default range
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=dtype, device=dev)

    inner = HEADS * DIM_HEAD
    x = t(B, N, DIM)
    qkv = [t(B, N, HEADS, DIM_HEAD) for _ in range(3)]
    scale = DIM_HEAD ** -0.5
    ln = (t(DIM, scale=0.1, dtype=torch.float32, offset=1.0),
          t(DIM, scale=0.1, dtype=torch.float32))
    wqkv = w(3 * inner, DIM, torch.bfloat16)
    wout, bout = w(DIM, inner, torch.bfloat16), t(DIM, scale=0.03,
                                                  dtype=torch.float32)
    w1, b1 = w(MLP, DIM, torch.bfloat16), t(MLP, scale=0.03,
                                            dtype=torch.float32)
    w2, b2 = w(DIM, MLP, torch.bfloat16), t(DIM, scale=0.02,
                                            dtype=torch.float32)
    attn = t(B, N, inner)
    mlp_args = (x, *ln, w1, b1, w2, b2)
    drop = {"dropout_rate": DROPOUT, "seed": 1234}
    mdrop = {"dropout_rate": DROPOUT, "seeds": (1235, 1236)}

    # The backward's residuals and cotangents, from the plain forwards.
    o, lsum = {}, {}
    h = {}
    for rate in (0.0, DROPOUT):
        o[rate], lsum[rate] = flash_attention.flash_attention_plain(
            *qkv, scale=scale, n_valid=N, dropout_rate=rate, seed=1234,
            return_stats=True)
        _, h[rate] = fused_mlp.fused_mlp_block_plain(
            *mlp_args, dropout_rate=rate, seeds=(1235, 1236), return_h=True)
    do = t(B, N, HEADS, DIM_HEAD)
    dqkv = [t(B, N, HEADS, DIM_HEAD, scale=0.1) for _ in range(3)]
    dy = t(B, N, DIM, scale=0.1)

    def attn_bwd(fn, rate):
        return lambda: fn(*qkv, o[rate], do, lsum[rate], scale=scale,
                          n_valid=N, dropout_rate=rate, seed=1234)

    def bhnd(t):            # [B, N, H, D] <-> [B, H, N, D]
        return t.transpose(1, 2).contiguous()

    # K6's operands: the same tensors in [B, H, N, D]; its residuals are
    # the bnhd plain forward's, transposed (the two layouts give the same
    # bits, tests/test_torch_gradcam.py).
    qkv_h, do_h = [bhnd(a) for a in qkv], bhnd(do)
    o_h = {rate: bhnd(o[rate]) for rate in o}

    def attn_bhnd_bwd(fn, rate):
        return lambda: fn(*qkv_h, o_h[rate], do_h, lsum[rate], scale=scale,
                          n_valid=N, dropout_rate=rate, seed=1234)

    def mlp_bwd(fn, rate):
        return lambda: fn(dy, x, h[rate], *ln, w1, w2, dropout_rate=rate,
                          seeds=(1235, 1236))

    def outproj_bwd(fn, rate):
        return lambda: fn(dy, wout, dropout_rate=rate, seed=1234)

    fa, oq, q8 = flash_attention, fused_qkv, int8_serving
    # int8 weights per output channel, from the same weights in f32.
    qkv8 = q8.quantize_weight(wqkv.float())
    out8 = q8.quantize_weight(wout.float())
    mlp8 = (*q8.quantize_weight(w1.float()), b1,
            *q8.quantize_weight(w2.float()), b2)
    # name -> [(label, kernel call, plain call, grads, params)]; the first
    # entry of each is the one timed into the JSON line.
    cases = {
        "flash_attention": [
            ("n_valid 1001", lambda: fa.flash_attention_cuda(
                *qkv, scale=scale, n_valid=N),
             lambda: fa.flash_attention_plain(*qkv, scale=scale, n_valid=N)),
            (f"n_valid {N_VALID_MASKED}", lambda: fa.flash_attention_cuda(
                *qkv, scale=scale, n_valid=N_VALID_MASKED),
             lambda: fa.flash_attention_plain(*qkv, scale=scale,
                                              n_valid=N_VALID_MASKED)),
            (f"dropout {DROPOUT}", lambda: fa.flash_attention_cuda(
                *qkv, scale=scale, n_valid=N, return_stats=True, **drop),
             lambda: fa.flash_attention_plain(
                 *qkv, scale=scale, n_valid=N, return_stats=True, **drop))],
        "fused_ln_qkv": [
            ("", lambda: oq.fused_ln_qkv_cuda(x, *ln, wqkv, HEADS, DIM_HEAD),
             lambda: oq.fused_ln_qkv_plain(x, *ln, wqkv, HEADS, DIM_HEAD)),
            ("with u", lambda: oq.fused_ln_qkv_cuda(
                x, *ln, wqkv, HEADS, DIM_HEAD, return_u=True),
             lambda: oq.fused_ln_qkv_plain(x, *ln, wqkv, HEADS, DIM_HEAD,
                                           return_u=True))],
        "fused_outproj_residual": [
            ("", lambda: fused_outproj.fused_outproj_residual_cuda(
                x, attn, wout, bout),
             lambda: fused_outproj.fused_outproj_residual_plain(
                 x, attn, wout, bout)),
            (f"dropout {DROPOUT}",
             lambda: fused_outproj.fused_outproj_residual_cuda(
                 x, attn, wout, bout, **drop),
             lambda: fused_outproj.fused_outproj_residual_plain(
                 x, attn, wout, bout, **drop))],
        "fused_mlp_block": [
            ("", lambda: fused_mlp.fused_mlp_block_cuda(*mlp_args),
             lambda: fused_mlp.fused_mlp_block_plain(*mlp_args)),
            (f"dropout {DROPOUT} with h",
             lambda: fused_mlp.fused_mlp_block_cuda(*mlp_args, return_h=True,
                                                    **mdrop),
             lambda: fused_mlp.fused_mlp_block_plain(*mlp_args, return_h=True,
                                                     **mdrop))],
        "flash_attention_bwd": [
            (f"dropout {rate}", attn_bwd(fa.flash_attention_bwd_cuda, rate),
             attn_bwd(fa.flash_attention_bwd_plain, rate), True, ())
            for rate in (DROPOUT, 0.0)],
        "flash_attention_bhnd": [
            ("n_valid 1001", lambda: fa.flash_attention_bhnd_cuda(
                *qkv_h, scale=scale, n_valid=N),
             lambda: fa.flash_attention_bhnd_plain(*qkv_h, scale=scale,
                                                   n_valid=N)),
            (f"n_valid {N_VALID_MASKED}", lambda: fa.flash_attention_bhnd_cuda(
                *qkv_h, scale=scale, n_valid=N_VALID_MASKED),
             lambda: fa.flash_attention_bhnd_plain(
                 *qkv_h, scale=scale, n_valid=N_VALID_MASKED)),
            (f"dropout {DROPOUT}", lambda: fa.flash_attention_bhnd_cuda(
                *qkv_h, scale=scale, n_valid=N, return_stats=True, **drop),
             lambda: fa.flash_attention_bhnd_plain(
                 *qkv_h, scale=scale, n_valid=N, return_stats=True, **drop))],
        "flash_attention_bhnd_bwd": [
            (f"dropout {rate}",
             attn_bhnd_bwd(fa.flash_attention_bhnd_bwd_cuda, rate),
             attn_bhnd_bwd(fa.flash_attention_bhnd_bwd_plain, rate), True, ())
            for rate in (0.0, DROPOUT)],
        "fused_ln_qkv_bwd": [
            ("", lambda: oq.fused_ln_qkv_bwd_cuda(*dqkv, x, ln[0], wqkv),
             lambda: oq.fused_ln_qkv_bwd_plain(*dqkv, x, ln[0], wqkv), True,
             (1, 2))],
        "fused_outproj_bwd": [
            (f"dropout {rate}",
             outproj_bwd(fused_outproj.fused_outproj_bwd_cuda, rate),
             outproj_bwd(fused_outproj.fused_outproj_bwd_plain, rate), True,
             ()) for rate in (DROPOUT, 0.0)],
        "fused_mlp_bwd": [
            (f"dropout {rate}", mlp_bwd(fused_mlp.fused_mlp_bwd_cuda, rate),
             mlp_bwd(fused_mlp.fused_mlp_bwd_plain, rate), True, (5, 6))
            for rate in (DROPOUT, 0.0)],
        "int8_ln_qkv": [
            ("", lambda: q8.int8_ln_qkv_cuda(x, *ln, *qkv8, HEADS, DIM_HEAD),
             lambda: q8.int8_ln_qkv_plain(x, *ln, *qkv8, HEADS, DIM_HEAD))],
        "int8_outproj_residual": [
            ("", lambda: q8.int8_outproj_residual_cuda(x, attn, *out8, bout),
             lambda: q8.int8_outproj_residual_plain(x, attn, *out8, bout))],
        "int8_mlp_block": [
            ("", lambda: q8.int8_mlp_block_cuda(x, *ln, *mlp8),
             lambda: q8.int8_mlp_block_plain(x, *ln, *mlp8))],
        "int8_flash_attention": [
            (f"n_valid {n_valid}", lambda n_valid=n_valid:
             q8.int8_flash_attention_cuda(*qkv, scale=scale, n_valid=n_valid),
             lambda n_valid=n_valid: q8.int8_flash_attention_plain(
                 *qkv, scale=scale, n_valid=n_valid))
            for n_valid in (N, N_VALID_MASKED)],
    }
    # (name, label) -> (what, call, layout): the bf16 kernel each int8
    # kernel stands in for, on the same inputs; K1 or K5 beside K6 on the
    # transposed inputs, with the largest difference of the outputs once
    # ``layout`` brings them to K6's layout.
    counterparts = {
        ("int8_ln_qkv", ""): ("bf16 counterpart", lambda: oq.fused_ln_qkv_cuda(
            x, *ln, wqkv, HEADS, DIM_HEAD), None),
        ("int8_outproj_residual", ""): ("bf16 counterpart", lambda: (
            fused_outproj.fused_outproj_residual_cuda(x, attn, wout, bout)),
            None),
        ("int8_mlp_block", ""): ("bf16 counterpart",
                                 lambda: fused_mlp.fused_mlp_block_cuda(
                                     *mlp_args), None),
        ("int8_flash_attention", f"n_valid {N}"): (
            "bf16 counterpart",
            lambda: fa.flash_attention_cuda(*qkv, scale=scale, n_valid=N),
            None),
    }
    for label, kw in ((f"n_valid {N}", {"n_valid": N}),
                      (f"n_valid {N_VALID_MASKED}",
                       {"n_valid": N_VALID_MASKED}),
                      (f"dropout {DROPOUT}", {"n_valid": N, **drop,
                                              "return_stats": True})):
        counterparts[("flash_attention_bhnd", label)] = (
            "K1 on the transposed inputs",
            lambda kw=kw: fa.flash_attention_cuda(*qkv, scale=scale, **kw),
            lambda out: [bhnd(out[0]), out[1]] if isinstance(out, tuple)
            else bhnd(out))
    for rate in (0.0, DROPOUT):
        counterparts[("flash_attention_bhnd_bwd", f"dropout {rate}")] = (
            "K5 on the transposed inputs",
            attn_bwd(fa.flash_attention_bwd_cuda, rate),
            lambda out: [bhnd(g) for g in out])
    results = {}
    for name, calls in cases.items():
        max_abs, max_rel = 0.0, 0.0
        for i, (label, kernel, plain, *check) in enumerate(calls):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            a, r = compare(f"{name} {label}", got, want, *check)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            other = counterparts.get((name, label))
            if i == 0 or "dropout" in label or other:
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                if i == 0:
                    results[name] = {"ms": ms, "plain_ms": plain_ms}
                log("kernels", f"{name} {label}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms at B={B} N={N}; max abs err {a:.3e}")
            if other:
                what, call, layout = other
                other_ms = cuda_ms(call)
                msg = f"{name} {label}: {what} {other_ms:.4f} ms"
                if layout is not None:
                    theirs = layout(call())
                    torch.cuda.synchronize()
                    theirs = ([theirs] if isinstance(theirs, torch.Tensor)
                              else theirs)
                    mine = [got] if isinstance(got, torch.Tensor) else got
                    diff = max(float((m.float() - t.float()).abs().max())
                               for m, t in zip(mine, theirs))
                    msg += f", largest difference from it {diff:.3e}"
                log("kernels", msg)
            del got, want
        results[name].update(max_abs_err=max_abs, max_rel_err=max_rel)
        log("kernels", f"{name}: max abs err {max_abs:.3e}, max rel err "
            f"{max_rel:.3e} over {len(calls)} cases; {card}")
    return results


def _volumes(rng, n: int, size: int) -> np.ndarray:
    return rng.standard_normal((n, size, size, size)).astype(np.float32)


def slice_phase(config, ckpt: str, predictor, rng, phase: str = "slice"
                ) -> tuple:
    """Requests of 1, 3 and 32 volumes against single calls, then the first
    volume against the same checkpoint (quantized like the predictor) on
    the CPU plain path. Returns the 32-volume request and its answer."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    size = config["TRAINING_VIT_INPUT_SIZE"]
    singles = {}
    for n in (1, 3, 32):
        vols = _volumes(rng, n, size)
        t0 = time.perf_counter()
        labels, probs = predictor(vols)
        secs = time.perf_counter() - t0
        if probs.shape != (n, 2) or labels.shape != (n,):
            raise AssertionError(f"n={n}: shapes {probs.shape}, {labels.shape}")
        if not np.isfinite(probs).all():
            raise AssertionError(f"n={n}: probabilities are not finite")
        if not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"n={n}: probabilities do not sum to 1")
        worst = 0.0
        for i in range(min(n, 3)):
            _, one = predictor(vols[i:i + 1])
            worst = max(worst, float(np.abs(one[0] - probs[i]).max()))
        if worst > PROB_ATOL:
            raise AssertionError(f"n={n}: bucket {predictor._bucket_for(n)} "
                                 f"differs from single calls by {worst}")
        singles[n] = (vols, probs)
        log(phase, f"n={n}: bucket {predictor._bucket_for(n)}, "
            f"{secs * 1e3:.1f} ms host clock, probs[0] {probs[0].tolist()}, "
            f"max diff vs single calls {worst:.3e} (tol {PROB_ATOL})")

    # The same checkpoint on the CPU plain path.
    cpu_model = NeuroEncoder(config, device="cpu", seed=SEED)
    load_checkpoint(cpu_model, ckpt, strict=True)
    if predictor.quant == "int8":
        quantize_blocks(cpu_model.volume_encoder.vit3d)
    vols, probs = singles[1]
    gpu_probs = probs[0]
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = cpu_model(torch.from_numpy(vols[:1]))
        cpu_probs = torch.softmax(logits.float(), dim=-1)[0].numpy()
    diff = float(np.abs(cpu_probs - gpu_probs).max())
    log(phase, f"cuda vs cpu plain path: probs {gpu_probs.tolist()} vs "
        f"{cpu_probs.tolist()}, max diff {diff:.3e} (tol {PROB_ATOL}); cpu "
        f"{time.perf_counter() - t0:.1f} s host clock")
    if diff > PROB_ATOL:
        raise AssertionError(f"cuda and cpu probabilities differ by {diff}")
    return singles[32]


def http_phase(predictor, rng, workdir: str, n_files: int = 3,
               concurrent: bool = True) -> None:
    """/healthz, then one POST of each of ``n_files`` NIfTI files and, with
    ``concurrent``, two of them again at once; every answer against
    Predictor."""
    from neurovit_tpu.data import nifti
    from neurovit_tpu_torch.serving import _collect_volume_jobs
    from neurovit_tpu_torch.serving_http import make_server

    paths = []
    for i in range(n_files):
        path = os.path.join(workdir, f"scan{i}.nii")
        # Raw 91 x 109 x 91: the ADNI crop [1:, 10:-9, 1:] gives 90^3.
        nifti.save(path, rng.standard_normal((91, 109, 91)).astype(np.float32))
        paths.append(path)
    want = {}
    for path in paths:
        _, _, vol = next(_collect_volume_jobs([path], crop=True))
        want[path] = predictor(vol[None])[1][0]

    server, batcher = make_server(predictor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results = []            # (path, status, payload) of every answer

    def post(path):
        with open(path, "rb") as f:
            req = urllib.request.Request(url + "/predict", data=f.read(),
                                         method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            results.append((path, resp.status, json.loads(resp.read())))

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
            if (resp.status != 200 or health["status"] != "ok"
                    or health["quant"] != predictor.quant):
                raise AssertionError(f"/healthz: {resp.status} {health}")
        log("http", f"/healthz {health}")
        for path in paths:
            post(path)
        threads = [threading.Thread(target=post, args=(p,))
                   for p in (paths[:2] if concurrent else [])]
        for c in threads:
            c.start()
        for c in threads:
            c.join(timeout=300)
            if c.is_alive():
                raise AssertionError("a concurrent POST did not finish")
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=60)
        server.server_close()
    if len(results) != len(paths) + len(threads):
        raise AssertionError(f"{len(results)} of {len(paths) + len(threads)} "
                             "POSTs answered")
    for path, status, payload in results:
        got = np.array(payload["rows"][0]["probs"])
        diff = float(np.abs(got - want[path]).max())
        log("http", f"POST {os.path.basename(path)}: {status}, probs "
            f"{got.tolist()}, max diff vs Predictor {diff:.3e}")
        if status != 200 or diff > PROB_ATOL:
            raise AssertionError(f"{path}: status {status}, diff {diff}")


def grad_phase(config) -> None:
    """Loss and every parameter gradient of the full-width flagship, batch
    2, dropout on, on cuda against the same weights on the CPU plain path.
    The Philox masks are the same bits on both devices."""
    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.models import NeuroEncoder

    config = dict(config, TRAINING_DROPOUT=DROPOUT)
    cpu = NeuroEncoder(config, device="cpu", seed=SEED)
    gpu = NeuroEncoder(config, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    vols = torch.from_numpy(_volumes(rng, 2, config["TRAINING_VIT_INPUT_SIZE"]))
    labels = torch.tensor([0, 1])
    losses = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        t0 = time.perf_counter()
        loss = nn.softmax_cross_entropy(
            model(vols.to(dev), train=True, seed=SEED), labels.to(dev))
        loss.backward()
        losses[name] = float(loss)
        log("grad", f"{name}: loss {losses[name]:.6f}, forward + backward "
            f"{time.perf_counter() - t0:.1f} s host clock")
    if abs(losses["cuda"] - losses["cpu"]) > 2e-2 * abs(losses["cpu"]):
        raise AssertionError(f"losses differ: {losses}")
    worst = ("", 0.0)
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        g, c = pg.grad.float().cpu(), pc.grad.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient is not finite")
        err = float((g - c).norm() / c.norm().clamp_min(1e-30))
        worst = max(worst, (name, err), key=lambda e: e[1])
        if err > GRAD_RTOL:
            raise AssertionError(f"{name}: gradient relative Frobenius "
                                 f"error {err:.3e} > {GRAD_RTOL}")
    n = sum(1 for _ in gpu.parameters())
    log("grad", f"{n} parameter gradients within {GRAD_RTOL}: worst "
        f"{worst[0]} at {worst[1]:.3e}")


class _SeededVolumes:
    """In-memory 90^3 volumes made from a seed, two classes: a volume of
    class 1 is brighter. The Trainer's DataLoader reads it like a
    dataset."""

    def __init__(self, n: int, size: int, seed: int, mode: str):
        self.n, self.size, self.seed, self.mode = n, size, seed, mode

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        label = idx % 2
        vol = rng.standard_normal((self.size,) * 3, dtype=np.float32)
        return {"volume": vol + 0.5 * label, "label": label,
                "subject": f"{self.mode}_{idx}", "timepoint": 0}


def _train_config(config, workdir: str, **extra):
    return {**config, "TRAINING_DROPOUT": DROPOUT,
            "TRAINING_LEARNING_RATE": 1e-4, "TRAINING_BATCH_SIZE": 32,
            "TRAINING_EPOCHS": 1, "TRAINING_NUM_WORKERS": 8,
            "WANDB_ENABLED": False,
            "GLOBAL_OUTPUT_DIR": os.path.join(workdir, "runs"), **extra}


def train_phase(config, workdir: str, counters: dict) -> dict:
    """Trainer.run() for one epoch on cuda, its checkpoint served, then 10
    steps on one fixed batch. Returns the launch counts of the run."""
    import glob

    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.training import Trainer

    cfg = _train_config(config, workdir)
    size = cfg["TRAINING_VIT_INPUT_SIZE"]
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    trainer = Trainer(cfg, model, _SeededVolumes(256, size, SEED, "train"),
                      _SeededVolumes(64, size, SEED + 1, "val"))
    depth = model.vit_cfg.depth
    forwards, steps = [0], [0]
    model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    step = trainer.train_step

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    trainer.train_step = counted_step
    out = io.StringIO()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    text = out.getvalue()
    for line in text.splitlines():
        log("train", line.expandtabs(1))
    for want in ("epoch 0\t| batch 7/8\t| train_loss: ",
                 "[VALIDATION] epoch 0\t| total_batch 1\t| val_loss ",
                 "MODEL SAVED to ."):
        if want not in text:
            raise AssertionError(f"Trainer.run() did not print {want!r}")
    pkl = glob.glob(os.path.join(cfg["GLOBAL_OUTPUT_DIR"], "*",
                                 "model-e0.state_dict.pkl"))
    if len(pkl) != 1 or not os.path.exists(pkl[0][:-len(".state_dict.pkl")]):
        raise AssertionError(f"checkpoints not written: {pkl}")
    log("train", f"one epoch ({steps[0]} steps, {forwards[0]} forwards) in "
        f"{secs:.1f} s host clock, data loading included; {pkl[0]}")

    log("counts", f"train run: {forwards[0]} forwards, {steps[0]} backwards "
        f"x depth {depth}; launches {launches}")
    for name, _, _ in KERNELS:
        want = (0 if name in INT8_KERNELS or name in GRADCAM_KERNELS else
                depth * (steps[0] if name.endswith("_bwd") else forwards[0]))
        if launches[name] != want or (want and launches[name] == 0):
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"the train run, expected {want}")

    predictor = Predictor.from_checkpoint(cfg, pkl[0], batch_size=1,
                                          bucket_sizes=(), device="cuda")
    vol = _SeededVolumes(1, size, SEED + 2, "serve").sample(0)["volume"]
    labels, probs = predictor(vol[None])
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(vol[None]).cuda()).float(),
                             -1).cpu().numpy()
    if not np.isfinite(probs).all() or np.abs(probs - want).max() > PROB_ATOL:
        raise AssertionError(f"served {probs} against the trainer's {want}")
    log("train", f"model-e0 served by Predictor: label {labels[0]}, probs "
        f"{probs[0].tolist()} (trainer's model {want[0].tolist()})")

    # Ten steps on one fixed batch, dropout off: the loss must fall. At
    # lr 1e-4 Adam's first sign-like steps move the untrained full-width
    # model's loss up and down on 8 samples; lr 1e-5 descends.
    cfg0 = dict(cfg, TRAINING_DROPOUT=0.0, TRAINING_BATCH_SIZE=8,
                TRAINING_LEARNING_RATE=1e-5)
    fixed = Trainer(cfg0, NeuroEncoder(cfg0, device="cuda", seed=SEED),
                    _SeededVolumes(8, size, SEED + 3, "fixed"),
                    _SeededVolumes(8, size, SEED + 3, "fixed"))
    batch, zyx, _ = next(fixed._device_prefetch(fixed.val_dataloader))
    losses = [float(fixed.train_step(batch, zyx)["loss"]) for _ in range(10)]
    log("train", f"fixed batch of 8, 10 steps at dropout 0, lr 1e-5: losses "
        f"{[round(v, 5) for v in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    del trainer, fixed, predictor
    return launches


def train_rate_phase(config, workdir: str, card: str, batch: int = 128
                     ) -> None:
    """Median train-step time at batch 128 (3 warm-up steps, 5 timed),
    vol/s, TFLOP/s from the shapes, peak memory, and a profiler split of
    one step by kernel."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer

    cfg = _train_config(config, workdir, TRAINING_BATCH_SIZE=batch)
    size = cfg["TRAINING_VIT_INPUT_SIZE"]
    ds = _SeededVolumes(batch, size, SEED + 4, "rate")
    trainer = Trainer(cfg, NeuroEncoder(cfg, device="cuda", seed=SEED), ds, ds)
    dbatch, zyx, _ = next(trainer._device_prefetch(trainer.val_dataloader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(dbatch, zyx)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tflops = TRAIN_GFLOP_PER_VOL * batch / ms
    log("train_rate", f"batch {batch}: step {ms:.2f} ms median of 5 "
        f"(all {[round(t * 1e3, 2) for t in times]}), "
        f"{batch / ms * 1e3:.1f} vol/s, {tflops:.1f} TFLOP/s "
        f"({TRAIN_GFLOP_PER_VOL:.1f} GFLOP/vol), peak memory {peak:.2f} GiB; "
        f"{card}")

    profile_split("train_rate", "step",
                  lambda: trainer.train_step(dbatch, zyx), ms)


def profile_split(phase: str, what: str, fn, ms: float) -> None:
    """Kernel time of one ``fn()`` by kernel, from torch.profiler, against
    its timed ``ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_ms(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr) / 1e3
        return 0.0

    rows = [(e.key, device_ms(e), e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and device_ms(e) > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(phase, f"profiled {what}: {total:.2f} ms of kernel time in "
        f"{sum(r[2] for r in rows)} launches, {100 * total / ms:.1f} % of "
        f"the timed {what}")
    for key, t, count in rows[:14]:
        log(phase, f"  {t:9.3f} ms {100 * t / max(total, 1e-9):5.1f} % "
            f"x{count:<4d} {key[:90]}")


def _count_forwards(model) -> list:
    """A one-element list that counts ``model``'s forward calls."""
    forwards = [0]
    model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    return forwards


def _check_counts(phase: str, launches: dict, want: dict) -> None:
    for name, count in launches.items():
        if count != want[name] or (want[name] and count == 0):
            raise AssertionError(f"{name} launched {count} times in {phase}, "
                                 f"expected {want[name]}")


def int8_phase(config, ckpt: str, rng, workdir: str, counters: dict) -> dict:
    """The checkpoint served with quant="int8" through Predictor and HTTP,
    with the launch counts of that run; then against the bf16 Predictor,
    and one forward with SERVING_INT8_ATTN off. Returns the counts."""
    from neurovit_tpu_torch.serving import Predictor

    predictor = Predictor.from_checkpoint(config, ckpt, batch_size=32,
                                          device="cuda", quant="int8")
    depth = predictor.model.vit_cfg.depth
    forwards = _count_forwards(predictor.model)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    predictor.warmup()
    log("int8", f"warmup of buckets {predictor.bucket_sizes}: "
        f"{time.perf_counter() - t0:.1f} s")
    vols, probs = slice_phase(config, ckpt, predictor, rng, phase="int8")
    http_phase(predictor, rng, workdir, n_files=1, concurrent=False)
    launches = {name: fn.launches for name, fn in counters.items()}
    log("int8", f"int8 serving: {forwards[0]} forward calls x depth {depth}; "
        f"launches {launches}")
    _check_counts("int8 serving", launches, {
        name: depth * forwards[0] if name in INT8_KERNELS else 0
        for name in counters})

    bf16 = Predictor.from_checkpoint(config, ckpt, batch_size=32,
                                     device="cuda")
    _, want = bf16(vols)
    diff = float(np.abs(probs - want).max())
    flips = int((probs.argmax(1) != want.argmax(1)).sum())
    log("int8", f"int8 vs bf16 Predictor, 32 volumes: max diff {diff:.3e} "
        f"(tol {INT8_ATOL}); argmax flips {flips}")
    if diff > INT8_ATOL:
        raise AssertionError(f"int8 and bf16 probabilities differ by {diff}")
    del bf16

    off = Predictor.from_checkpoint(dict(config, SERVING_INT8_ATTN=False),
                                    ckpt, batch_size=1, bucket_sizes=(),
                                    device="cuda", quant="int8")
    for fn in counters.values():
        fn.launches = 0
    _, got = off(vols[:1])
    counts = {name: fn.launches for name, fn in counters.items()}
    _check_counts("the SERVING_INT8_ATTN: off forward", counts, {
        name: depth if name in ("int8_ln_qkv", "int8_outproj_residual",
                                "int8_mlp_block", "flash_attention") else 0
        for name in counters})
    diff = float(np.abs(got[0] - probs[0]).max())
    log("int8", f"SERVING_INT8_ATTN off: probs {got[0].tolist()}, max diff "
        f"vs pv {diff:.3e} (tol {INT8_ATOL}); launches {counts}")
    if diff > INT8_ATOL:
        raise AssertionError(f"int8_attn off and pv differ by {diff}")
    return launches


def rate_phase(config, ckpt: str, card: str, batch: int = 32) -> None:
    """The int8 and the bf16 forward at batch 32, device-only: two medians
    of 10 CUDA-event timings each, taken in turns bf16, int8, int8, bf16,
    and their mean; then a profiler split of the int8 forward."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    size = config["TRAINING_VIT_INPUT_SIZE"]
    vols = torch.from_numpy(_volumes(np.random.default_rng(SEED + 5), batch,
                                     size)).cuda()
    models = {}
    for quant in ("bf16", "int8"):
        models[quant] = NeuroEncoder(config, device="cuda", seed=SEED).eval()
        load_checkpoint(models[quant], ckpt, strict=True)
        if quant == "int8":
            quantize_blocks(models[quant].volume_encoder.vit3d)
    times = {"bf16": [], "int8": []}
    with torch.inference_mode():
        for quant in ("bf16", "int8", "int8", "bf16"):
            times[quant].append(cuda_ms(lambda: models[quant](vols),
                                        warmup=2, runs=10))
        for quant, ms in times.items():
            mean = float(np.mean(ms))
            log("rate", f"{quant} forward at batch {batch}: {mean:.3f} ms "
                f"(runs {[round(t, 3) for t in ms]}), "
                f"{batch / mean * 1e3:.1f} vol/s; {card}")
        profile_split("rate", "int8 forward", lambda: models["int8"](vols),
                      float(np.mean(times["int8"])))


def _lift_layer_norms(model, seed: int) -> None:
    """Move every LayerNorm affine off its init (ones, zeros) with seeded
    noise, as training moves them. At the init the probe activation sums
    to zero over the features, so the reference's raw CAM (the mean
    gradient times that sum) is rounding noise, and two devices' maps of it
    cannot agree."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.LayerNorm):
                for p, base in ((module.weight, 1.0), (module.bias, 0.0)):
                    p.copy_(torch.from_numpy(
                        base + 0.3 * rng.standard_normal(tuple(p.shape))))


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError("a Grad-CAM output is not finite")
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def gradcam_phase(config, ckpt: str, workdir: str, card: str,
                  counters: dict) -> dict:
    """Grad-CAM of the flagship on cuda (see the module docstring, phase
    8). Returns the launch counts of one get_attention_map call."""
    from neurovit_tpu.data import nifti
    from neurovit_tpu_torch.explainability import bcos, cam_methods, driver
    from neurovit_tpu_torch.explainability import gradcam_vit3d as gc
    from neurovit_tpu_torch.explainability import integrated_gradients as ig
    from neurovit_tpu_torch.explainability import shap_values
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    size = config["TRAINING_VIT_INPUT_SIZE"]
    threshold = float(config["GRADCAM_THRESHOLD"])
    cpu = NeuroEncoder(config, device="cpu", seed=SEED)
    load_checkpoint(cpu, ckpt, strict=True)
    _lift_layer_norms(cpu, SEED)
    model = NeuroEncoder(config, device="cuda", seed=SEED)
    model.load_state_dict(cpu.state_dict(), strict=True)
    depth = model.vit_cfg.depth
    rng = np.random.default_rng(SEED + 6)
    vols = _volumes(rng, 4, size)

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cams, idx = model.get_attention_map(vols)
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    log("gradcam", f"get_attention_map of 4 volumes: classes {idx.tolist()}, "
        f"{secs * 1e3:.1f} ms host clock (first call); launches {launches}")
    want = {name: 0 for name in counters}
    want.update({name: depth - 1 for name in (
        "flash_attention", "fused_ln_qkv", "fused_outproj_residual")})
    want.update(fused_mlp_block=depth, flash_attention_bhnd=1,
                flash_attention_bhnd_bwd=1, fused_mlp_bwd=1)
    _check_counts("one get_attention_map", launches, want)
    if (cams.shape != (4, size, size, size) or not np.isfinite(cams).all()
            or cams.min() < 0 or cams.max() > 1 + 1e-6):
        raise AssertionError(f"maps: shape {cams.shape}, range "
                             f"[{cams.min()}, {cams.max()}]")

    # Probe gradients and raw CAMs: the batch against single volumes, and
    # the first volume against the CPU plain path.
    x = torch.from_numpy(vols).cuda()
    _, idx4, acts4, grads4 = gc.probe_acts_grads(model, x)
    raw4 = gc.raw_attention_map(model, acts4, grads4)
    worst = 0.0
    for i in range(4):
        _, idx1, acts1, grads1 = gc.probe_acts_grads(model, x[i:i + 1])
        raw1 = gc.raw_attention_map(model, acts1, grads1)
        if i == 0:
            single = (idx1, acts1, grads1, raw1)
        errs = (_rel_err(grads4[i:i + 1], grads1), _rel_err(raw4[i:i + 1],
                                                            raw1))
        worst = max(worst, *errs)
        if int(idx1) != int(idx4[i]) or max(errs) > GRAD_RTOL:
            raise AssertionError(f"volume {i}: batched against single: "
                                 f"classes {int(idx4[i])}, {int(idx1)}; "
                                 f"gradient, raw CAM errors {errs}")
    log("gradcam", f"batch of 4 against single volumes: classes equal, "
        f"gradients and raw CAMs within {worst:.3e} (tol {GRAD_RTOL})")
    t0 = time.perf_counter()
    logits_c, idx_c, acts_c, grads_c = gc.probe_acts_grads(
        cpu, torch.from_numpy(vols[:1]))
    raw_c = gc.raw_attention_map(cpu, acts_c, grads_c)
    errs = {"activations": _rel_err(single[1], acts_c),
            "gradients": _rel_err(single[2], grads_c),
            "raw CAM": _rel_err(single[3], raw_c)}
    final = gc.finalize_cam(raw_c, size, threshold).numpy()[0]
    log("gradcam", f"cuda against the cpu plain path: class "
        f"{int(single[0])} / {int(idx_c)}, relative errors "
        f"{ {k: round(v, 6) for k, v in errs.items()} } (tol {GRAD_RTOL}); "
        f"final maps differ by at most {np.abs(final - cams[0]).max():.3e}; "
        f"cpu {time.perf_counter() - t0:.1f} s host clock")
    if int(single[0]) != int(idx_c) or max(errs.values()) > GRAD_RTOL:
        raise AssertionError(f"cuda and cpu Grad-CAM differ: {errs}")

    # The menu, once each on one volume, with what each launched.
    for method in cam_methods.METHODS:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        cam, cls = cam_methods.compute_cam(model, vols[0], method=method)
        secs = time.perf_counter() - t0
        ran = {n: c.launches for n, c in counters.items() if c.launches}
        if (cam.shape != (size,) * 3 or not np.isfinite(cam).all()
                or cam.min() < 0 or cam.max() > 1 + 1e-6):
            raise AssertionError(f"{method}: map shape {cam.shape}, range "
                                 f"[{cam.min()}, {cam.max()}]")
        backward = {n: c for n, c in ran.items() if n.endswith("_bwd")}
        forward_only = method in cam_methods.FORWARD_METHODS
        if (ran.get("flash_attention_bhnd", 0) < 1
                or bool(backward) == forward_only):
            raise AssertionError(f"{method} launched {ran}")
        log("gradcam", f"{method}: class {cls.tolist()}, "
            f"{(cam > 0).mean() * 100:.2f} % of voxels kept, "
            f"{secs * 1e3:.0f} ms host clock; launches {ran}")

    noise = rng.standard_normal(vols[0].shape).astype(np.float32)
    t0 = time.perf_counter()
    attr, cls = ig.integrated_gradients(model, vols[0], baseline=noise,
                                        steps=8)
    gap = ig.completeness_gap(model, vols[0], baseline=noise, steps=8)
    log("gradcam", f"integrated gradients, 8 steps: class {cls.tolist()}, "
        f"|attr| max {np.abs(attr).max():.3e}, completeness gap {gap:.3e}; "
        f"{time.perf_counter() - t0:.1f} s host clock with the gap")
    shap, shap_cls = shap_values.kernel_shap(model, vols[0], region_size=18,
                                             nsamples=32, batch_size=16)
    contrib, bcos_cls = bcos.explain(model, vols[0])
    for what, a in (("integrated gradients", attr), ("kernel SHAP", shap),
                    ("grad x input", contrib)):
        if a.shape != vols[0].shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: shape {a.shape} or not finite")
    log("gradcam", f"kernel SHAP ({(size // 18) ** 3} regions, 32 "
        f"coalitions): class "
        f"{shap_cls}, |phi| max {np.abs(shap).max():.3e}; grad x input: "
        f"class {bcos_cls.tolist()}, sum {float(contrib.sum()):.4e}")

    # The driver on seeded volumes, each map written as NIfTI.
    dataset = _SeededVolumes(3, size, SEED + 7, "cam")
    dcfg = dict(config, GRADCAM_OUTPUT_DIR=os.path.join(workdir, "cams"))
    for sid in range(3):
        _, img, attn, cls, sample = driver.get_sample_gradcam(
            model, dataset, sid, dcfg)
        cam, _ = model.get_attention_map(sample["volume"])
        path = driver.save_gradcam_nifti(cam, sid, dcfg)
        back = nifti.load(path).get_fdata(np.float32)
        axial = dcfg["GRADCAM_SLICE_IDX"]
        if (not np.array_equal(back, cam)
                or not np.array_equal(attn, cam[:, :, axial])):
            raise AssertionError(f"sample {sid}: the saved map or the slice "
                                 "differs from the map")
    log("gradcam", f"driver: 3 samples, slices and NIfTI maps in "
        f"{dcfg['GRADCAM_OUTPUT_DIR']}")

    # Latency, device-only by CUDA events: probe forward, backward and tail.
    times = {}
    for b in (1, 8):
        xb = torch.from_numpy(_volumes(rng, b, size)).cuda()
        times[b] = cuda_ms(lambda: gc.attention_map(model, xb, threshold),
                           warmup=2, runs=10)
        log("gradcam", f"Grad-CAM at batch {b}: {times[b]:.3f} ms, "
            f"{b / times[b] * 1e3:.1f} vol/s; {card}")
        profile_split("gradcam", f"Grad-CAM at batch {b}",
                      lambda: gc.attention_map(model, xb, threshold),
                      times[b])
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on the card only", file=sys.stderr)
        return 1
    from neurovit_tpu.config import load_config
    from neurovit_tpu_torch.ops import (_build, flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv,
                                        int8_serving)
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.models import NeuroEncoder

    # The plain versions' f32 matmuls are the reference: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {card}; torch: {kind}, "
        f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log("build", f"{lib.name} in {time.perf_counter() - t0:.1f} s")

    kernel_stats = kernel_phase(card)
    torch.cuda.empty_cache()

    counters = {
        "flash_attention": flash_attention.flash_attention_cuda,
        "fused_ln_qkv": fused_qkv.fused_ln_qkv_cuda,
        "fused_outproj_residual": fused_outproj.fused_outproj_residual_cuda,
        "fused_mlp_block": fused_mlp.fused_mlp_block_cuda,
        "flash_attention_bwd": flash_attention.flash_attention_bwd_cuda,
        "fused_ln_qkv_bwd": fused_qkv.fused_ln_qkv_bwd_cuda,
        "fused_outproj_bwd": fused_outproj.fused_outproj_bwd_cuda,
        "fused_mlp_bwd": fused_mlp.fused_mlp_bwd_cuda,
        "int8_ln_qkv": int8_serving.int8_ln_qkv_cuda,
        "int8_outproj_residual": int8_serving.int8_outproj_residual_cuda,
        "int8_mlp_block": int8_serving.int8_mlp_block_cuda,
        "int8_flash_attention": int8_serving.int8_flash_attention_cuda,
        "flash_attention_bhnd": flash_attention.flash_attention_bhnd_cuda,
        "flash_attention_bhnd_bwd":
            flash_attention.flash_attention_bhnd_bwd_cuda,
    }
    config = load_config()
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as workdir:
        ckpt = os.path.join(workdir, "flagship.pt")
        torch.save(NeuroEncoder(config, device="cpu", seed=SEED).state_dict(),
                   ckpt)
        predictor = Predictor.from_checkpoint(config, ckpt, batch_size=32,
                                              device="cuda")
        depth = predictor.model.vit_cfg.depth
        forwards = _count_forwards(predictor.model)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        predictor.warmup()
        log("slice", f"warmup of buckets {predictor.bucket_sizes}: "
            f"{time.perf_counter() - t0:.1f} s")
        slice_phase(config, ckpt, predictor, rng)
        http_phase(predictor, rng, workdir)
        serving = {name: fn.launches for name, fn in counters.items()}
        log("http", f"serving: {forwards[0]} forward calls x depth {depth}; "
            f"launches {serving}")
        _check_counts("serving", serving, {
            name: 0 if name.endswith("_bwd") or name in INT8_KERNELS
            or name in GRADCAM_KERNELS else depth * forwards[0]
            for name in counters})
        del predictor
        torch.cuda.empty_cache()

        int8_launches = int8_phase(config, ckpt, rng, workdir, counters)
        torch.cuda.empty_cache()
        rate_phase(config, ckpt, card)
        torch.cuda.empty_cache()
        gradcam_launches = gradcam_phase(config, ckpt, workdir, card,
                                         counters)
        torch.cuda.empty_cache()

        grad_phase(config)
        torch.cuda.empty_cache()
        launches = train_phase(config, workdir, counters)
        torch.cuda.empty_cache()
        train_rate_phase(config, workdir, card)

    launches.update({name: int8_launches[name] for name in INT8_KERNELS})
    launches.update({name: gradcam_launches[name]
                     for name in GRADCAM_KERNELS})
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": kernel_stats[name]["max_abs_err"],
         "ms": kernel_stats[name]["ms"],
         "plain_ms": kernel_stats[name]["plain_ms"]}
        for name, source, replaces in KERNELS]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
