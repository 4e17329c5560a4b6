#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (neurovit_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:

1. device      nvidia-smi's name and power limit, torch's device name
2. build       compile the kernels from neurovit_tpu_torch/csrc; from the
               build's log, every ptxas note on a kernel (C7514, wgmma
               serialised, among them) and every kernel that spills, and
               the registers of the attention backward's instances and of
               the passes of K2, K4, K7-K13
3. kernels     each kernel against its plain PyTorch version on the card, at
               the flagship shapes (batch 8 x 1001 tokens), with CUDA-event
               timings of both: the forwards K1-K4 at dropout 0 (K2 also
               with u, at 130 rows and on all-zero rows with beta = 0,
               which give q = k = v = 0, and two calls bit-equal, u
               included), K1, K3 and
               K4 again at dropout 0.1 (the same mask bits on both sides;
               K3 also at 130 rows;
               K4 with h, also at 130 rows and at dim 1280 / mlp 5120 and
               dim 1024 / mlp 8192 at batch 2, and on all-zero rows, which
               give bf16(b2), and two calls bit-equal),
               the backwards K5, K7, K8, K9 at dropout 0 and 0.1 (K8 also
               at 130 rows, its dz bit-equal to plain's, dy itself at
               dropout 0, and two calls bit-equal; K7 also
               at 130 rows and on all-zero rows of dqkv, which give dx = 0
               there, and two calls bit-equal; K9 also
               at 130 rows and at dim 1280 / mlp 5120 and dim 1536 / mlp
               6144 at batch 2, on all-zero rows of dy, which give dz =
               dh = dx = 0 there, and two calls bit-equal), K6 (the
               [B, H, N, D] attention) forward at n_valid 1001 and 900 and
               at dropout 0.1 and backward at dropout 0 and 0.1, each also
               timed beside K1 or K5 on the transposed inputs, and the int8
               kernels K10-K13 (K13 also at n_valid 900; K10 also at 130
               rows and on all-zero rows with beta = 0, which give q = k =
               v = 0, and two calls bit-equal; K11 bit-equal to plain, also
               at 130 rows and on all-zero rows of a, which give bf16(b +
               x), and two calls bit-equal; K12 also at 130
               rows, at dim 1280 / mlp 5120 and dim 1024 / mlp 8192 at
               batch 2, and on all-zero rows, which give bf16(b2), and two
               calls bit-equal), each timed beside its bf16 counterpart
               (K2, K3, K4, K1) on the same inputs; then the profiler's
               device times of K1 and K6 (and K1 at dropout 0.1) beside
               SDPA's in both layouts, the enqueue time per call and the
               exp2 floor, and of K5 (dropout 0.1 and 0) and K6's backward
               beside SDPA's backward
               (scripts/torch_attention_device_times.py), of K10's two
               passes beside K17 int8 and torch._int_mm at its GEMM's shape
               (scripts/torch_int8_qkv_device_times.py), of K12's four
               passes beside K17 int8 at its two GEMM shapes
               (scripts/torch_int8_mlp_device_times.py), of K13's three
               launches at n_valid 1001 and 900 beside K1's device time
               (scripts/torch_int8_attention_device_times.py), and of K4's three
               passes, serving and at dropout 0.1 with h, beside K17 bf16
               at its two GEMM shapes (scripts/torch_mlp_device_times.py),
               of K9's five passes at dropout 0.1 and 0 beside K17
               bf16 at its two GEMM shapes
               (scripts/torch_mlp_bwd_device_times.py), and of K7's four
               passes beside K17 bf16 at du's shape, the bound and the
               design's bytes (scripts/torch_qkv_bwd_device_times.py), and
               of K2's two passes beside K17 bf16 at its GEMM's shape, the
               bound and the design's bytes
               (scripts/torch_qkv_device_times.py), and of K3 at dropout 0
               and 0.1, K11's two passes and K8 at dropout 0.1 and 0
               beside torch.mm, K17 bf16, torch._int_mm, K17 int8 and
               torch.mm(dy, Wout) at their GEMMs' shapes, with the bound
               and the design's bytes
               (scripts/torch_outproj_device_times.py)
4. widths      every ViT width of the matrix (models/vit3d.py WIDTHS: the
               smoke model, head dims 32, 80 and 128, ViT-S/B/L and the
               flagship) at batch 2 x 1001 tokens through K1-K13 against the
               plain versions, dropout 0.1 where an op has it; K4's, K9's,
               K2's, K10's and K7's plans (scratch, shared memory) against
               the kernels'; K4 and K9 at ViT-H (dim 1280, mlp 5120)
               against plain; K2, K10 and K7 at ViT-H (dim 1280, 16 heads x
               80), at dim 1536 / inner 1536 and at dim 2048 / inner 2048,
               batch 2 and 130 rows, against plain, and K3 (dropout 0.1),
               K11 (bit-equal) and K8 (dropout 0.1, dz bit-equal) there
               too, with their plans (K11's scratch, the three GEMMs'
               shared memory) against the kernels'; K4
               and K9 timed at batch 8 at the ViT-B, ViT-L, ViT-H and
               flagship widths
5. probes      the probe scripts' main paths with their launch counts
               (scripts/torch_dropout_bench.py, scripts/torch_int8_gemm_bench.py
               at its seven shapes); K16 forward and backward at
               [32 * 1001, 2048] bf16 bit-equal to plain, keep fraction within
               4 sigma; at each of the seven GEMM shapes K17 int8 and K18
               bit-equal, K17 bf16 within K 2^-23 sum|a||b|, each timed
               beside plain and library calls, and its device time from the
               profiler with its rate and its transpose step's share (the
               kernel table's row is fc1)
6. slice       the flagship model (configs/config.yaml, seed 42) saved with
               torch.save, served by Predictor.from_checkpoint on cuda:
               warmup, then requests of 1, 3 and 32 volumes; checked against
               single-volume calls and against the same model on the CPU
7. http        the HTTP server on an ephemeral port: /healthz, then /predict
               with three NIfTI files, two of them posted concurrently;
               every forward kernel launched depth times per forward of 4-5
8. int8        the same checkpoint served with quant="int8": warmup,
               requests of 1, 3 and 32 volumes against single calls and
               against the quantized model on the CPU plain path; against
               the bf16 Predictor within 0.05; /healthz says "int8" and one
               /predict equals Predictor; K10-K13 launched depth times per
               forward and K1-K4 never; one forward with SERVING_INT8_ATTN
               off runs K1 in place of K13
9. rate        the int8 and the bf16 forward at batch 32, device-only by
               CUDA events, and a profiler split of each
10. gradcam    Grad-CAM of the same checkpoint with its LayerNorm affines
               moved off their init: the launch counts of one
               get_attention_map of 4 volumes (K1-K3 depth - 1 times, K4
               depth times, K6 forward and backward and K9 once, no other
               backward kernel); probe gradients and raw CAMs of the batch
               against single volumes and one volume against the CPU plain
               path; every menu method, integrated gradients, Kernel SHAP
               and grad x input once; the driver's get_sample_gradcam with
               the map written as NIfTI and read back; Grad-CAM latency at
               batch 1 and 8 by CUDA events, each with a profiler split
11. grad       the flagship at batch 2, dropout 0.1: loss and every
               parameter's gradient on cuda against the CPU plain path
12. train      Trainer.run() for one epoch of seeded 90^3 volumes (batch 32,
               8 train and 2 val batches); its checkpoint served by
               Predictor; then 10 steps on one fixed batch at dropout 0
13. train_rate train steps at batch 128: median step time, vol/s, TFLOP/s,
               peak memory, and a profiler split of one step
14. counts     in phase 12, every bf16 forward kernel launched depth times
               per forward and every backward kernel depth times per
               backward
15. train_features
               the flagship width (dim 1024, 8 heads of 64, MLP
               2048, 1001 tokens, bf16): (a) remat: a train step at
               batch 128, dropout 0.1, without TRAINING_REMAT, again
               without, and with it on the same weights, batch and seed:
               the remat step's loss and every parameter gradient equal
               the first step's where the two steps without remat are
               bit-equal, else within their largest gap; each step's
               launches (K1-K4 2 x depth - 1 times with remat, depth
               without; each backward kernel depth times); step ms
               (median of 5 after 3 warm-ups) and peak memory with and
               without remat; (b) Trainer.run() of 6 steps at batch 8
               with TRAINING_PROFILE_STEPS 2: the Chrome trace under
               GLOBAL_OUTPUT_DIR/profile names every CUDA kernel of
               K1-K5 and K7-K9; (c) two epochs twice on the same seeds,
               with TRAINING_ASYNC_CHECKPOINT and without: both epochs'
               train states and weight files equal tensor for tensor,
               and each run's epoch times; (d) main(["--sweep", ...]) in
               this process: SWEEP_COUNT 2 at depth 2 on a synthetic
               gradcam set under a GLOBAL_BASE_PATH holding
               configs/sweep.yaml with epochs cut to [1], two trials with
               finite val_loss, their parameters those of run_sweep on
               the CPU at the seed, card memory after trial 2 within 5 %
               of after trial 1
16. resnet     the full-width ResNet-18 (the config with
               MODEL_VOLUME_ENCODER: resnet, bf16, seed 42) saved with
               torch.save and served by Predictor (requests of 1, 3 and 32
               against single calls and the CPU plain path) and one HTTP
               /predict; its gradients at batch 2 in train mode, with
               cuDNN's global TF32 flag at its default: f32 on cuda against
               the CPU plain path, and bf16 on both devices against the
               CPU's f32 (the card no farther than the plain path);
               Trainer.run() for one epoch, its checkpoint (running stats
               included) served back; 10 bf16 steps on one fixed batch,
               the loss falling; the train step at
               batch 64 (median ms, vol/s, peak memory, a profiler split);
               the three CAMs at batch 1 against the CPU plain path and
               their latency at batch 1 and 8 by CUDA events; K14 launched
               once per forward and K15 once per backward, and K15 never in
               a CAM
17. 4d         configs/config4D.yaml (the flagship ViT frozen, seed 42)
               on seeded [90^3, 140] series, 4 train and 2 val at batch 2,
               accumulation 2: (a) Trainer.run() for 2 epochs, the encoder
               bit-unchanged, the head moved, K1-K4 depth times per
               encoder forward and no backward kernel; (b) the feature
               cache: K1-K4 only in the precompute, losses against (a)'s,
               cached features against a fresh encode_sequence, a second
               Trainer reloading the persisted views with no launch; (c)
               the int8 encoder: K10-K13 and never K1-K4, its features
               within 5e-2 of the bf16 encoder's, its checkpoint with
               (a)'s keys and f32 encoder weights; (d) 4D encodings
               bit-equal to the 3D forward on the same volumes; the fold of
               all 280 volumes against the CPU plain path at the first and
               last 3 timepoints of each sequence (encodings, and the ViT's
               last block output per volume, each nearest its own CPU row);
               the head at f32 against the CPU plain path; a T = 4
               sequence's encodings and logits against the CPU; (e) Predictor at 1 and 2 sequences bit-equal, the batch
               CLI on two NIfTI series (timepoint -1 rows), HTTP /healthz
               (is_4d) and a POSTed series, --quant int8; (f) the train
               step at B 2 x T 140, with the cache and with the int8
               encoder, the encoder's share, peak memory, profiler splits;
               (g) the ResNet-18 encoder in 4D at B 1 x T 8, one K14, its
               encodings and the logits against the CPU plain path
18. widths     the verify recipe's smoke model (dim 64, 4 heads of 16)
               trained for an epoch in bf16 on cuda through the CLI's main(),
               every block kernel launched; a ViT-B-width model (768, 12 x
               64, 3072, depth 4) served by Predictor against the CPU plain
               path

The kernel phase also checks K14 (the stem's max-pool with its argmax
codes) and K15 (its backward) at [8, 90, 45, 45, 64] bf16 on a continuous,
a tie-heavy and a NaN and +-inf input: values, codes and dx bit-equal to
the plain version (NaN where it has NaN), and logs their device times
beside F.max_pool3d's and its backward's with their bound
(scripts/torch_pool_device_times.py); each kernel is timed beside one
PyTorch call computing
the same function where there is one (scaled_dot_product_attention,
F.max_pool3d and its backward), and its bound computed from its bytes and
operations. The backward attention kernels' library call is SDPA's
backward: ``torch.autograd.grad`` of ``F.scaled_dot_product_attention`` at
dropout 0 on the same q, k, v and dO, its graph built once.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, the script exits
non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import gc
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
# The ResNet's bf16 gradients in train mode are far from its f32 ones on
# either device (PERF.md: one bf16 rounding moves them by tens of percent).
# The card's are held to be no farther from the CPU's f32 gradients than
# the CPU plain path's bf16 gradients are: at most this factor times the
# plain path's error, plus GRAD_RTOL, in the worst and the median parameter.
BF16_GRAD_RATIO = 1.5
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
    ("max_pool3d_argmax", "neurovit_tpu_torch/csrc/maxpool3d.cu",
     "neurovit_tpu/ops/maxpool3d.py:62"),
    ("max_pool3d_argmax_bwd", "neurovit_tpu_torch/csrc/maxpool3d.cu",
     "neurovit_tpu/ops/maxpool3d.py:188"),
    ("dropout", "neurovit_tpu_torch/csrc/dropout.cu",
     "neurovit_tpu/ops/dropout.py:30"),
    ("gemm_bf16", "neurovit_tpu_torch/csrc/int8_gemm.cu",
     "scripts/int8_pallas_bench.py:30"),
    ("gemm_int8", "neurovit_tpu_torch/csrc/int8_gemm.cu",
     "scripts/int8_pallas_bench.py:30"),
    ("dynquant_matmul", "neurovit_tpu_torch/csrc/int8_gemm.cu",
     "scripts/int8_pallas_bench.py:55"),
]
INT8_KERNELS = [name for name, _, _ in KERNELS if name.startswith("int8_")]
# K6: only the Grad-CAM probe's last block runs it.
GRADCAM_KERNELS = ["flash_attention_bhnd", "flash_attention_bhnd_bwd"]
# K14, K15: only the ResNet's stem runs them.
RESNET_KERNELS = ["max_pool3d_argmax", "max_pool3d_argmax_bwd"]
# K16-K18: only the probe scripts run them.
PROBE_KERNELS = ["dropout", "gemm_bf16", "gemm_int8", "dynquant_matmul"]
# Kernels no ViT block forward or backward launches.
OFF_BLOCK_KERNELS = (INT8_KERNELS + GRADCAM_KERNELS + RESNET_KERNELS
                     + PROBE_KERNELS)
# K16's x in its probe (scripts/torch_dropout_bench.py); the GEMM probe's
# shapes are its SHAPES, fc1 first.
DROPOUT_SHAPE = (32 * 1001, 2048)
# The ResNet stem's pool input at batch 8: [B, 90, 45, 45, 64] NDHWC.
POOL_SHAPE = (B, 90, 45, 45, 64)
# The card's peaks for the bound (H100 SXM data sheet, dense): device
# memory bytes/s and operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


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


def compare(name: str, got, want, grads: bool = False, params=(),
            mode: str = "") -> tuple:
    """Elementwise check of every output (``grads``: the backward's
    tolerance); outputs at the indices ``params`` are parameter gradients,
    checked by relative Frobenius error. ``mode`` "exact": every output
    equal bit for bit; "ulp": within one bf16 ulp of the plain value;
    "nan": inputs with NaN and +-inf, every output equal to the plain
    version's and NaN exactly where it is NaN (a NaN's bits may differ)."""
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    max_abs, max_rel = 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if mode == "exact" and (g.dtype != w.dtype or not torch.equal(g, w)):
            raise AssertionError(f"{name}: output {i} differs from the "
                                 "plain version")
        if mode == "nan":
            nan = torch.isnan(w)
            if g.dtype != w.dtype or not torch.equal(torch.isnan(g), nan) \
                    or not torch.equal(g[~nan], w[~nan]):
                raise AssertionError(f"{name}: output {i} differs from the "
                                     "plain version")
            continue
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
        if mode == "ulp":       # bf16 keeps 8 bits: ulp 2^(e - 7)
            tol = torch.where(w == 0, torch.zeros_like(w), torch.exp2(
                torch.floor(torch.log2(w.abs())) - 7))
        elif mode == "exact":
            tol = torch.zeros_like(w)
        else:
            tol = ((BWD_ATOL + BWD_FRAC * w.abs().max()) if grads
                   else ATOL) + RTOL * w.abs()
        bad = diff > tol
        if bad.any():
            raise AssertionError(
                f"{name}: output {i}: {int(bad.sum())} elements outside the "
                f"tolerance (max abs err {float(diff.max()):.3e})")
    return max_abs, max_rel


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_bytes: int, out_bytes: int, ops: dict) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the card's memory
    rate and its operations over the peak rate of their type."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def script(name: str):
    """The module of ``scripts/<name>.py``, loaded by path."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def attention_device_times(results: dict, qkv: list, qkv_h: list,
                           card: str) -> None:
    """The device times of K1 and K6 at dropout 0 and of SDPA in both
    layouts (``scripts/torch_attention_device_times.py``), into the
    kernels' results; K1's at dropout 0.1 and the enqueue time per call
    logged beside them, with the bound and the exp2 floor. Then those of K5
    (at dropout 0.1, its timed case, and 0) and K6's backward (dropout 0)
    beside SDPA's backward, each pass's time logged."""
    times = script("torch_attention_device_times")
    floor = times.exp2_floor_ms(B)
    for name, layout, ops in (("flash_attention", "bnhd", qkv),
                              ("flash_attention_bhnd", "bhnd", qkv_h)):
        m = times.measure(ops, layout, 0.0, 10)
        results[name].update(device_ms=m["device_ms"],
                             library_device_ms=m["library_device_ms"])
        msg = (f"{name}: device {m['device_ms']} ms, SDPA device "
               f"{m['library_device_ms']} ms, bound "
               f"{results[name]['bound_ms']:.4f} ms, exp2 floor {floor:.4f} "
               f"ms; enqueue {m['enqueue_us']:.1f} us a call (SDPA "
               f"{m['library_enqueue_us']:.1f})")
        if layout == "bnhd":
            drop = times.measure(ops, layout, DROPOUT, 10)["device_ms"]
            msg += f"; at dropout {DROPOUT} device {drop} ms"
            if drop and m["device_ms"]:
                msg += f" ({drop / m['device_ms']:.2f}x)"
        log("kernels", f"{msg}; {card}")
    # The backward, K5 first at dropout 0.1 (its timed case), then 0.
    for name, layout, ops, rates in (
            ("flash_attention_bwd", "bnhd", qkv, (DROPOUT, 0.0)),
            ("flash_attention_bhnd_bwd", "bhnd", qkv_h, (0.0,))):
        for rate in rates:
            m = times.measure_bwd(ops, layout, rate, 10)
            if rate == rates[0]:
                results[name].update(
                    device_ms=m["device_ms"],
                    library_device_ms=m["library_device_ms"])
            log("kernels", f"{name} at dropout {rate}: device "
                f"{m['device_ms']} ms (passes "
                f"{sorted(round(v, 1) for v in m['passes_us'].values())} "
                f"us), SDPA backward device {m['library_device_ms']} ms, "
                f"bound {results[name]['bound_ms']:.4f} ms; enqueue "
                f"{m['enqueue_us']:.1f} us a call (SDPA "
                f"{m['library_enqueue_us']:.1f}); {card}")


def int8_mlp_device_times(results: dict, args: tuple, card: str) -> None:
    """K12's device time on the kernel phase's operands, pass by pass
    (``scripts/torch_int8_mlp_device_times.py``), into its result; K17
    int8 at the two GEMM shapes logged beside it."""
    times = script("torch_int8_mlp_device_times")
    m = times.measure(args, 10)
    results["int8_mlp_block"]["device_ms"] = m["device_ms"]
    log("kernels", times.line(f"int8_mlp_block at B={B} N={N}", m)
        + f", bound {results['int8_mlp_block']['bound_ms']:.4f} ms; {card}")
    for shape, dev in times.yardstick(B * N, DIM, MLP, 10).items():
        log("kernels", f"K17 int8 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def int8_qkv_device_times(results: dict, args: tuple, card: str) -> None:
    """K10's device time on the kernel phase's operands, pass by pass
    (``scripts/torch_int8_qkv_device_times.py``), into its result; K17 int8
    and ``torch._int_mm`` at its GEMM's shape logged beside it."""
    times = script("torch_int8_qkv_device_times")
    m = times.measure(args, 10)
    results["int8_ln_qkv"]["device_ms"] = m["device_ms"]
    log("kernels", times.line(f"int8_ln_qkv at B={B} N={N}", m, times.floors(
        B * N, DIM, HEADS * DIM_HEAD)) + f"; {card}")
    for shape, dev in times.yardstick(B * N, DIM, HEADS * DIM_HEAD,
                                      10).items():
        log("kernels", f"{shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def int8_attention_device_times(results: dict, qkv: list, card: str) -> None:
    """K13's device time on the kernel phase's q, k, v at n_valid N (its
    timed case) and N_VALID_MASKED, launch by launch
    (``scripts/torch_int8_attention_device_times.py``), the first into its
    result, each beside K1's on the same operands."""
    times = script("torch_int8_attention_device_times")
    for n_valid in (N, N_VALID_MASKED):
        m = times.measure(qkv, n_valid, 10)
        if n_valid == N:
            results["int8_flash_attention"]["device_ms"] = m["device_ms"]
        log("kernels", times.line("int8_flash_attention", B, DIM_HEAD,
                                  n_valid, m) + f"; {card}")


def mlp_device_times(results: dict, args: tuple, card: str) -> None:
    """K4's device time on the kernel phase's operands, pass by pass
    (``scripts/torch_mlp_device_times.py``), into its result, and as the
    train step calls it (dropout 0.1, h stored); K17 bf16 at the two GEMM
    shapes logged beside it."""
    times = script("torch_mlp_device_times")
    m = times.measure(args, 10)
    results["fused_mlp_block"]["device_ms"] = m["device_ms"]
    log("kernels", times.line(f"fused_mlp_block at B={B} N={N}", m)
        + f", bound {results['fused_mlp_block']['bound_ms']:.4f} ms; {card}")
    log("kernels", times.line(
        f"fused_mlp_block at B={B} N={N} dropout {DROPOUT} with h",
        times.measure(args, 10, **times.TRAIN)) + f"; {card}")
    for shape, dev in times.yardstick(B * N, DIM, MLP, 10).items():
        log("kernels", f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def mlp_bwd_device_times(results: dict, args: tuple, card: str) -> None:
    """K9's device time on the kernel phase's operands at dropout 0.1 (its
    timed case) and 0, pass by pass (``scripts/torch_mlp_bwd_device_times.py``),
    the first into its result; K17 bf16 at the two GEMM shapes logged
    beside it."""
    times = script("torch_mlp_bwd_device_times")
    for rate in (DROPOUT, 0.0):
        m = times.measure(args, 10, dropout_rate=rate, seeds=(1235, 1236))
        if rate == DROPOUT:
            results["fused_mlp_bwd"]["device_ms"] = m["device_ms"]
        log("kernels", times.line(
            f"fused_mlp_bwd at B={B} N={N} dropout {rate}", m)
            + f", bound {results['fused_mlp_bwd']['bound_ms']:.4f} ms; {card}")
    for shape, dev in times.yardstick(B * N, DIM, MLP, 10).items():
        log("kernels", f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def qkv_bwd_device_times(results: dict, args: tuple, card: str) -> None:
    """K7's device time on the kernel phase's operands, pass by pass
    (``scripts/torch_qkv_bwd_device_times.py``), into its result; beside
    it, K17 bf16 at du's shape, the bound and the design's bytes floor."""
    times = script("torch_qkv_bwd_device_times")
    m = times.measure(args, 10)
    results["fused_ln_qkv_bwd"]["device_ms"] = m["device_ms"]
    log("kernels", times.line(f"fused_ln_qkv_bwd at B={B} N={N}", m, B * N)
        + f"; {card}")
    for shape, dev in times.yardstick(B * N, DIM, HEADS * DIM_HEAD,
                                      10).items():
        log("kernels", f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def qkv_device_times(results: dict, args: tuple, card: str) -> None:
    """K2's device time on the kernel phase's operands, pass by pass
    (``scripts/torch_qkv_device_times.py``), into its result, and as the
    train step calls it (u returned); beside it, K17 bf16 at its GEMM's
    shape, the bound and the design's bytes floor."""
    times = script("torch_qkv_device_times")
    f = times.floors(B * N, DIM, HEADS * DIM_HEAD)
    m = times.measure(args, 10)
    results["fused_ln_qkv"]["device_ms"] = m["device_ms"]
    log("kernels", times.line(f"fused_ln_qkv at B={B} N={N}", m, f)
        + f"; {card}")
    log("kernels", times.line(f"fused_ln_qkv at B={B} N={N} with u",
                              times.measure(args, 10, True), f) + f"; {card}")
    for shape, dev in times.yardstick(B * N, DIM, HEADS * DIM_HEAD,
                                      10).items():
        log("kernels", f"K17 bf16 {shape}: " + (", ".join(
            f"{k} {us:.1f} us" for k, us in dev.items()) or
            "device not measured (no kernels traced)") + f"; {card}")


def outproj_device_times(results: dict, card: str) -> None:
    """The device times of K3 at dropout 0 and 0.1, K11 pass by pass and
    K8 at dropout 0 and 0.1 at the kernel phase's shapes, on the script's
    own seeded operands (``scripts/torch_outproj_device_times.py``): K3's
    and K11's first cases and K8's at dropout 0.1 into their results; the
    yardsticks at their GEMMs' shapes logged beside them."""
    times = script("torch_outproj_device_times")
    lines, measured = times.run(B, 10)
    for key, name in (("K3", "fused_outproj_residual"),
                      ("K11", "int8_outproj_residual"),
                      (f"K8 dropout {DROPOUT}", "fused_outproj_bwd")):
        results[name]["device_ms"] = measured[key]["device_ms"]
    for text in lines:
        log("kernels", f"{text.strip()}; {card}")


def pool_device_times(results: dict, card: str) -> None:
    """The device times of K14 and K15 at the kernel phase's pool shape
    beside F.max_pool3d and its backward, with their bound, on the
    script's own seeded operands (``scripts/torch_pool_device_times.py``),
    into the two kernels' results."""
    times = script("torch_pool_device_times")
    lines, measured = times.run(B, 10)
    for name, key, lib in (("max_pool3d_argmax", "K14", "F.max_pool3d"),
                           ("max_pool3d_argmax_bwd", "K15",
                            "max_pool3d_with_indices_backward")):
        results[name].update(device_ms=measured[key]["device_ms"],
                             library_device_ms=measured[lib]["device_ms"])
    for text in lines:
        log("kernels", f"{text.strip()}; {card}")


def build_notes(lib) -> None:
    """Log, from the build's compiler output, every ptxas note on a kernel
    (C7514 and C7512, wgmma serialised; C7508, setmaxnreg ignored) and
    every kernel that spills, with its name, and the registers of each
    instance of the attention backward, of K12's four passes, of K4's
    three, of K9's five, of K7's four, of K2's GEMM, of K10's and K11's
    row pass and of K8's GEMM."""
    from neurovit_tpu_torch.ops import _build
    path = _build.build_log(lib)
    if not path.exists():
        log("build", f"no build log at {path} (the library was built "
            "before the log was kept)")
        return
    kernels, notes = _build.ptxas_report(path.read_text())
    names = sorted({k[1] for k in kernels} | {n[1] for n in notes if n[1]})
    readable = dict(zip(names, names))
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            readable = dict(zip(names, out.stdout.splitlines()))
    except OSError:
        pass
    for source, fn, regs, stores, loads in kernels:
        if (stores or loads or "flash_bwd" in fn
                or source in ("int8_qkv.cu", "int8_rowquant.cu",
                              "int8_mlp.cu", "fused_mlp.cu", "fused_qkv.cu",
                              "int8_outproj.cu", "fused_outproj.cu",
                              "fused_outproj_bwd.cu",
                              "fused_mlp_bwd.cu", "fused_qkv_bwd.cu",
                              "int8_attention.cu")):
            log("build", f"{source} {readable.get(fn, fn)}: {regs} "
                f"registers, spill stores {stores} B, spill loads {loads} B")
    for source, fn, line in notes:
        log("build", f"{source} {readable.get(fn, fn)}: {line}")
    log("build", f"ptxas: {len(kernels)} kernels, "
        f"{sum(1 for k in kernels if k[3] or k[4])} spilling, {len(notes)} "
        f"notes ({sum('C7514' in n[2] for n in notes)} C7514)")


def kernel_phase(card: str) -> dict:
    import torch.nn.functional as F

    from neurovit_tpu_torch.ops import (flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv,
                                        int8_serving)
    from neurovit_tpu_torch.ops import maxpool3d as mp

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
    # [dq | dk | dv], K7's one A operand.
    dqkv = torch.cat([t(B, N, inner, scale=0.1) for _ in range(3)], dim=2)
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
    # K12 beyond the flagship: a ragged last row tile (130 rows), the two
    # widths the wmma version refused (ViT-H, mlp 8192) at batch 2, and
    # all-zero rows of x with beta = b1 = 0 (u and g all zero: amax 0,
    # scale 1) at a tile's first and last row.
    mlp8_more = {"130 rows": (x[:1, :130].contiguous(), *ln, *mlp8)}
    for dim_, hid_ in ((1280, 5120), (1024, 8192)):
        xw = t(2, N, dim_)
        mlp8_more[f"dim {dim_} mlp {hid_}"] = (
            xw, t(dim_, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim_, scale=0.1, dtype=torch.float32),
            *q8.quantize_weight(w(hid_, dim_)),
            t(hid_, scale=0.03, dtype=torch.float32),
            *q8.quantize_weight(w(dim_, hid_)),
            t(dim_, scale=0.02, dtype=torch.float32))
    x0 = x.clone()
    x0[0, [0, 127, 128, 1000]] = 0
    # K4 beyond the flagship, at dropout 0.1 with h: a ragged last row tile
    # (130 rows), the two widths the wmma version refused (ViT-H, mlp 8192)
    # at batch 2; all-zero rows with beta = b1 = 0 at dropout 0.
    mlp_more = {"130 rows": (x[:1, :130].contiguous(), *ln, w1, b1, w2, b2)}
    for dim_, hid_ in ((1280, 5120), (1024, 8192), (1536, 6144)):
        mlp_more[f"dim {dim_} mlp {hid_}"] = (
            t(2, N, dim_), t(dim_, scale=0.1, dtype=torch.float32, offset=1.0),
            t(dim_, scale=0.1, dtype=torch.float32),
            w(hid_, dim_, torch.bfloat16),
            t(hid_, scale=0.03, dtype=torch.float32),
            w(dim_, hid_, torch.bfloat16),
            t(dim_, scale=0.02, dtype=torch.float32))
    mlp_zero = (x0, ln[0], torch.zeros_like(ln[1]), w1, torch.zeros_like(b1),
                w2, b2)
    # K9 beyond the flagship, at dropout 0.1: the first 130 rows, and the
    # widths the wmma version refused (ViT-H, dim 1536 / mlp 6144) at batch
    # 2 on the plain forward's h; dy with all-zero rows at a tile's first
    # and last row (dz, dh and dx are 0 there).
    bwd_more = {"130 rows": (dy[:1, :130].contiguous(),
                             x[:1, :130].contiguous(),
                             h[DROPOUT][:1, :130].contiguous(), *ln, w1, w2)}
    for label in ("dim 1280 mlp 5120", "dim 1536 mlp 6144"):
        a = mlp_more[label]
        _, h_ = fused_mlp.fused_mlp_block_plain(*a, return_h=True, **mdrop)
        bwd_more[label] = (t(*a[0].shape, scale=0.1), a[0], h_, a[1], a[2],
                           a[3], a[5])
    dy0 = dy.clone()
    dy0[0, [0, 127, 128, 1000]] = 0
    bwd_more["zero rows of dy"] = (dy0, x, h[DROPOUT], *ln, w1, w2)
    mlp8_more["zero rows, beta = b1 = 0"] = (
        x0, ln[0], torch.zeros_like(ln[1]), mlp8[0], mlp8[1],
        torch.zeros_like(b1), *mlp8[3:])
    # K7 beyond the flagship: a ragged last row tile (130 rows), and
    # all-zero rows of dqkv at a tile's first and last row (du is 0 there,
    # so dx is).
    dqkv0 = dqkv.clone()
    dqkv0[0, [0, 127, 128, 1000]] = 0
    qkv_bwd = {"": (dqkv, x, ln[0], wqkv),
               "130 rows": (dqkv[:1, :130].contiguous(),
                            x[:1, :130].contiguous(), ln[0], wqkv),
               "zero rows of dqkv": (dqkv0, x, ln[0], wqkv)}
    # K2 beyond the flagship, with u: a ragged last row tile (130 rows),
    # and all-zero rows of x with beta = 0 (u all zero) at a tile's first
    # and last row.
    qkv_more = {
        "130 rows": (x[:1, :130].contiguous(), *ln, wqkv, HEADS, DIM_HEAD),
        "zero rows, beta = 0": (x0, ln[0], torch.zeros_like(ln[1]), wqkv,
                                HEADS, DIM_HEAD)}
    # K10 beyond the flagship: a ragged last row tile (130 rows), and
    # all-zero rows of x with beta = 0 (u all zero: amax 0, scale 1) at a
    # tile's first and last row.
    qkv8_more = {
        "130 rows": (x[:1, :130].contiguous(), *ln, *qkv8, HEADS, DIM_HEAD),
        "zero rows, beta = 0": (x0, ln[0], torch.zeros_like(ln[1]), *qkv8,
                                HEADS, DIM_HEAD)}
    # K11 beyond the flagship: a ragged last row tile (130 rows), and
    # all-zero rows of a (amax 0, scale 1, codes 0) at a tile's first and
    # last row, which give y = bf16(b + x) there.
    attn0 = attn.clone()
    attn0[0, [0, 127, 128, 1000]] = 0
    out_130 = (x[:1, :130].contiguous(), attn[:1, :130].contiguous())
    dy_130 = dy[:1, :130].contiguous()
    out8_more = {"130 rows": (*out_130, *out8, bout),
                 "zero rows of a": (x, attn0, *out8, bout)}
    # K14/K15 at the ResNet stem's shape: continuous values; post-ReLU
    # zeros and small integers in bf16, where most windows tie; continuous
    # values with 3 % NaN, 3 % +inf and 6 % -inf.
    nan_inf = rng.standard_normal(POOL_SHAPE)
    pick = rng.random(POOL_SHAPE)
    nan_inf[pick < 0.03] = np.nan
    nan_inf[(pick >= 0.03) & (pick < 0.06)] = np.inf
    nan_inf[(pick >= 0.06) & (pick < 0.12)] = -np.inf
    pools = {"continuous": t(*POOL_SHAPE),
             "tie-heavy": torch.tensor(np.maximum(rng.integers(
                 -3, 4, POOL_SHAPE), 0), dtype=torch.bfloat16, device=dev),
             "NaN and inf": torch.tensor(nan_inf, dtype=torch.bfloat16,
                                         device=dev)}
    del nan_inf, pick
    pool_codes = {k: mp.max_pool3d_argmax_plain(v)[1]
                  for k, v in pools.items()}
    pool_g = t(B, *(mp.out_dim(n) for n in POOL_SHAPE[1:4]), POOL_SHAPE[4])
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
                                           return_u=True)),
            *[(f"{label} with u",
               lambda a=a: oq.fused_ln_qkv_cuda(*a, return_u=True),
               lambda a=a: oq.fused_ln_qkv_plain(*a, return_u=True))
              for label, a in qkv_more.items()]],
        "fused_outproj_residual": [
            ("", lambda: fused_outproj.fused_outproj_residual_cuda(
                x, attn, wout, bout),
             lambda: fused_outproj.fused_outproj_residual_plain(
                 x, attn, wout, bout)),
            (f"dropout {DROPOUT}",
             lambda: fused_outproj.fused_outproj_residual_cuda(
                 x, attn, wout, bout, **drop),
             lambda: fused_outproj.fused_outproj_residual_plain(
                 x, attn, wout, bout, **drop)),
            (f"130 rows dropout {DROPOUT}",
             lambda: fused_outproj.fused_outproj_residual_cuda(
                 *out_130, wout, bout, **drop),
             lambda: fused_outproj.fused_outproj_residual_plain(
                 *out_130, wout, bout, **drop))],
        "fused_mlp_block": [
            ("", lambda: fused_mlp.fused_mlp_block_cuda(*mlp_args),
             lambda: fused_mlp.fused_mlp_block_plain(*mlp_args)),
            (f"dropout {DROPOUT} with h",
             lambda: fused_mlp.fused_mlp_block_cuda(*mlp_args, return_h=True,
                                                    **mdrop),
             lambda: fused_mlp.fused_mlp_block_plain(*mlp_args, return_h=True,
                                                     **mdrop)),
            *[(f"{label} dropout {DROPOUT} with h",
               lambda a=a: fused_mlp.fused_mlp_block_cuda(*a, return_h=True,
                                                          **mdrop),
               lambda a=a: fused_mlp.fused_mlp_block_plain(*a, return_h=True,
                                                           **mdrop))
              for label, a in mlp_more.items()],
            ("zero rows, beta = b1 = 0",
             lambda: fused_mlp.fused_mlp_block_cuda(*mlp_zero),
             lambda: fused_mlp.fused_mlp_block_plain(*mlp_zero))],
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
            (label, lambda a=a: oq.fused_ln_qkv_bwd_cuda(*a),
             lambda a=a: oq.fused_ln_qkv_bwd_plain(*a), True, (1, 2))
            for label, a in qkv_bwd.items()],
        "fused_outproj_bwd": [
            *[(f"dropout {rate}",
               outproj_bwd(fused_outproj.fused_outproj_bwd_cuda, rate),
               outproj_bwd(fused_outproj.fused_outproj_bwd_plain, rate),
               True, ()) for rate in (DROPOUT, 0.0)],
            (f"130 rows dropout {DROPOUT}",
             lambda: fused_outproj.fused_outproj_bwd_cuda(dy_130, wout,
                                                         **drop),
             lambda: fused_outproj.fused_outproj_bwd_plain(dy_130, wout,
                                                          **drop), True,
             ())],
        "fused_mlp_bwd": [
            *[(f"dropout {rate}", mlp_bwd(fused_mlp.fused_mlp_bwd_cuda, rate),
               mlp_bwd(fused_mlp.fused_mlp_bwd_plain, rate), True, (5, 6))
              for rate in (DROPOUT, 0.0)],
            *[(f"{label} dropout {DROPOUT}",
               lambda a=a: fused_mlp.fused_mlp_bwd_cuda(*a, **mdrop),
               lambda a=a: fused_mlp.fused_mlp_bwd_plain(*a, **mdrop), True,
               (5, 6)) for label, a in bwd_more.items()]],
        "int8_ln_qkv": [
            ("", lambda: q8.int8_ln_qkv_cuda(x, *ln, *qkv8, HEADS, DIM_HEAD),
             lambda: q8.int8_ln_qkv_plain(x, *ln, *qkv8, HEADS, DIM_HEAD)),
            *[(label, lambda a=a: q8.int8_ln_qkv_cuda(*a),
               lambda a=a: q8.int8_ln_qkv_plain(*a))
              for label, a in qkv8_more.items()]],
        "int8_outproj_residual": [
            ("", lambda: q8.int8_outproj_residual_cuda(x, attn, *out8, bout),
             lambda: q8.int8_outproj_residual_plain(x, attn, *out8, bout),
             False, (), "exact"),
            *[(label, lambda a=a: q8.int8_outproj_residual_cuda(*a),
               lambda a=a: q8.int8_outproj_residual_plain(*a), False, (),
               "exact") for label, a in out8_more.items()]],
        "int8_mlp_block": [
            ("", lambda: q8.int8_mlp_block_cuda(x, *ln, *mlp8),
             lambda: q8.int8_mlp_block_plain(x, *ln, *mlp8)),
            *[(label, lambda a=a: q8.int8_mlp_block_cuda(*a),
               lambda a=a: q8.int8_mlp_block_plain(*a))
              for label, a in mlp8_more.items()]],
        "int8_flash_attention": [
            (f"n_valid {n_valid}", lambda n_valid=n_valid:
             q8.int8_flash_attention_cuda(*qkv, scale=scale, n_valid=n_valid),
             lambda n_valid=n_valid: q8.int8_flash_attention_plain(
                 *qkv, scale=scale, n_valid=n_valid))
            for n_valid in (N, N_VALID_MASKED)],
        "max_pool3d_argmax": [
            (kind, lambda x=x: mp.max_pool3d_argmax_cuda(x),
             lambda x=x: mp.max_pool3d_argmax_plain(x), False, (),
             "nan" if kind == "NaN and inf" else "exact")
            for kind, x in pools.items()],
        "max_pool3d_argmax_bwd": [
            (kind, lambda c=c: mp.max_pool3d_argmax_bwd_cuda(
                c, pool_g, POOL_SHAPE, torch.bfloat16),
             lambda c=c: mp.max_pool3d_argmax_bwd_plain(
                 c, pool_g, POOL_SHAPE, torch.bfloat16), True, (), "exact")
            for kind, c in pool_codes.items()],
    }
    # The inputs and operations of each kernel's first (timed) case, for
    # its bound: attention 4 B H N^2 D forward, 2.5 times that backward
    # (flash_attention.py:434); a GEMM 2 M K N.
    att = 4 * B * HEADS * N * N * DIM_HEAD
    work = {
        "flash_attention": (nbytes(*qkv), {"bf16": att}),
        "flash_attention_bhnd": (nbytes(*qkv_h), {"bf16": att}),
        "fused_ln_qkv": (nbytes(x, *ln, wqkv),
                         {"bf16": 2 * B * N * DIM * 3 * inner}),
        "fused_outproj_residual": (nbytes(x, attn, wout, bout),
                                   {"bf16": 2 * B * N * inner * DIM}),
        "fused_mlp_block": (nbytes(*mlp_args), {"bf16": 4 * B * N * DIM * MLP}),
        "flash_attention_bwd": (nbytes(*qkv, o[DROPOUT], do, lsum[DROPOUT]),
                                {"bf16": 2.5 * att}),
        "flash_attention_bhnd_bwd": (nbytes(*qkv_h, o_h[0.0], do_h,
                                            lsum[0.0]), {"bf16": 2.5 * att}),
        "fused_ln_qkv_bwd": (nbytes(dqkv, x, ln[0], wqkv),
                             {"bf16": 2 * B * N * 3 * inner * DIM}),
        "fused_outproj_bwd": (nbytes(dy, wout),
                              {"bf16": 2 * B * N * DIM * inner}),
        "fused_mlp_bwd": (nbytes(dy, x, h[DROPOUT], *ln, w1, w2),
                          {"bf16": 4 * B * N * DIM * MLP}),
        "int8_ln_qkv": (nbytes(x, *ln, *qkv8),
                        {"int8": 2 * B * N * DIM * 3 * inner}),
        "int8_outproj_residual": (nbytes(x, attn, *out8, bout),
                                  {"int8": 2 * B * N * inner * DIM}),
        "int8_mlp_block": (nbytes(x, *ln, *mlp8),
                           {"int8": 4 * B * N * DIM * MLP}),
        "int8_flash_attention": (nbytes(*qkv), {"bf16": att / 2,
                                                "int8": att / 2}),
        "max_pool3d_argmax": (nbytes(pools["continuous"]), {}),
        "max_pool3d_argmax_bwd": (nbytes(pool_codes["continuous"], pool_g),
                                  {}),
    }
    # One PyTorch call computing the same function, where there is one: a
    # yardstick only, never called by the port.
    def sdpa_bwd(q_, k_, v_, do_):
        """SDPA's backward on [B, H, N, D] views at dropout 0, its graph
        built once here."""
        leaves = [a.detach().requires_grad_() for a in (q_, k_, v_)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        return lambda: torch.autograd.grad(out, leaves, do_,
                                           retain_graph=True)

    pool_x = pools["continuous"].permute(0, 4, 1, 2, 3)   # NCDHW view
    _, pool_idx = F.max_pool3d(pool_x, 3, 2, 1, return_indices=True)
    library = {
        "flash_attention": lambda: F.scaled_dot_product_attention(
            *(a.transpose(1, 2) for a in qkv), scale=scale),
        "flash_attention_bhnd": lambda: F.scaled_dot_product_attention(
            *qkv_h, scale=scale),
        "max_pool3d_argmax": lambda: F.max_pool3d(pool_x, 3, 2, 1,
                                                  return_indices=True),
        "max_pool3d_argmax_bwd":
            lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                pool_g.permute(0, 4, 1, 2, 3), pool_x, [3] * 3, [2] * 3,
                [1] * 3, [1] * 3, False, pool_idx),
        "flash_attention_bwd": sdpa_bwd(*(a.transpose(1, 2)
                                          for a in (*qkv, do))),
        "flash_attention_bhnd_bwd": sdpa_bwd(*qkv_h, do_h),
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
                    in_bytes, ops = work[name]
                    bound_ms, bound_by = bound(in_bytes, nbytes(*(
                        [got] if isinstance(got, torch.Tensor) else got)),
                        ops)
                    results[name] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": (cuda_ms(library[name])
                                       if name in library else None)}
                    log("kernels", f"{name}: bound {bound_ms:.4f} ms by "
                        f"{bound_by}, library call "
                        f"{results[name]['library_ms']} ms")
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
    zero_rows = [0, 127, 128, 1000]
    if any(t_.reshape(B * N, -1)[zero_rows].float().abs().max()
           for t_ in oq.fused_ln_qkv_cuda(*qkv_more["zero rows, beta = 0"],
                                          return_u=True)):
        raise AssertionError("fused_ln_qkv: an all-zero row with beta = 0 "
                             "does not give u = q = k = v = 0")
    for label, a in (("flagship", (x, *ln, wqkv, HEADS, DIM_HEAD)),
                     ("130 rows", qkv_more["130 rows"])):
        one, two = (oq.fused_ln_qkv_cuda(*a, return_u=True) for _ in range(2))
        served = oq.fused_ln_qkv_cuda(*a)
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"fused_ln_qkv {label}: two calls differ")
        if not all(torch.equal(p, q) for p, q in zip(one, served)):
            raise AssertionError(f"fused_ln_qkv {label}: q, k, v served "
                                 "differ from q, k, v with u")
    log("kernels", "fused_ln_qkv: all-zero rows with beta = 0 give u = q = "
        "k = v = 0; two calls with u bit-equal, and q, k, v served equal "
        "to them, at the flagship and at 130 rows")
    if any(t_.reshape(B * N, -1)[zero_rows].float().abs().max()
           for t_ in q8.int8_ln_qkv_cuda(*qkv8_more["zero rows, beta = 0"])):
        raise AssertionError("int8_ln_qkv: an all-zero row with beta = 0 "
                             "does not give q = k = v = 0")
    for label, a in (("flagship", (x, *ln, *qkv8, HEADS, DIM_HEAD)),
                     ("130 rows", qkv8_more["130 rows"])):
        one, two = (q8.int8_ln_qkv_cuda(*a) for _ in range(2))
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"int8_ln_qkv {label}: two calls differ")
    log("kernels", "int8_ln_qkv: all-zero rows with beta = 0 give q = k = "
        "v = 0; two calls bit-equal at the flagship and at 130 rows")
    y0 = q8.int8_outproj_residual_cuda(*out8_more["zero rows of a"])
    if not torch.equal(y0[0, [0, 127, 128, 1000]], (
            bout + x[0, [0, 127, 128, 1000]].float()).to(torch.bfloat16)):
        raise AssertionError("int8_outproj_residual: an all-zero row of a is "
                             "not bf16(b + x)")
    for label, a in (("flagship", (x, attn, *out8, bout)),
                     ("130 rows", out8_more["130 rows"])):
        if not torch.equal(q8.int8_outproj_residual_cuda(*a),
                           q8.int8_outproj_residual_cuda(*a)):
            raise AssertionError(f"int8_outproj_residual {label}: two calls "
                                 "differ")
    log("kernels", "int8_outproj_residual: all-zero rows of a give bf16(b + "
        "x); two calls bit-equal at the flagship and at 130 rows")
    y0 = q8.int8_mlp_block_cuda(*mlp8_more["zero rows, beta = b1 = 0"])
    if not torch.equal(y0[0, [0, 127, 128, 1000]],
                       b2.to(torch.bfloat16).expand(4, -1)):
        raise AssertionError("int8_mlp_block: an all-zero row is not bf16(b2)")
    for label, a in (("flagship", (x, *ln, *mlp8)),
                     ("130 rows", mlp8_more["130 rows"])):
        if not torch.equal(q8.int8_mlp_block_cuda(*a),
                           q8.int8_mlp_block_cuda(*a)):
            raise AssertionError(f"int8_mlp_block {label}: two calls differ")
    log("kernels", "int8_mlp_block: all-zero rows give bf16(b2); two calls "
        "bit-equal at the flagship and at 130 rows")
    y0 = fused_mlp.fused_mlp_block_cuda(*mlp_zero)
    if not torch.equal(y0[0, [0, 127, 128, 1000]],
                       b2.to(torch.bfloat16).expand(4, -1)):
        raise AssertionError("fused_mlp_block: an all-zero row is not "
                             "bf16(b2)")
    for label, a in (("flagship", mlp_args),
                     ("130 rows", mlp_more["130 rows"])):
        one, two = (fused_mlp.fused_mlp_block_cuda(*a, return_h=True, **mdrop)
                    for _ in range(2))
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise AssertionError(f"fused_mlp_block {label}: two calls "
                                 "differ")
    log("kernels", "fused_mlp_block: all-zero rows give bf16(b2); two calls "
        f"at dropout {DROPOUT} with h bit-equal at the flagship and at 130 "
        "rows")
    bwd_args = (dy, x, h[DROPOUT], *ln, w1, w2)
    got0 = fused_mlp.fused_mlp_bwd_cuda(*bwd_more["zero rows of dy"], **mdrop)
    for i, what in ((0, "dx"), (3, "dz"), (4, "dh")):
        if got0[i].reshape(B * N, -1)[[0, 127, 128, 1000]].float().abs().max():
            raise AssertionError(f"fused_mlp_bwd: {what} is not 0 on an "
                                 "all-zero row of dy")
    for label, a in (("flagship", bwd_args), ("130 rows", bwd_more["130 rows"]),
                     ("dim 1536 mlp 6144", bwd_more["dim 1536 mlp 6144"])):
        one, two = (fused_mlp.fused_mlp_bwd_cuda(*a, **mdrop)
                    for _ in range(2))
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"fused_mlp_bwd {label}: two calls differ")
    log("kernels", "fused_mlp_bwd: all-zero rows of dy give dz = dh = dx = "
        f"0; two calls at dropout {DROPOUT} bit-equal (dgamma and dbeta "
        "included) at the flagship, at 130 rows and at dim 1536 / mlp 6144")
    dx0, _, _ = oq.fused_ln_qkv_bwd_cuda(*qkv_bwd["zero rows of dqkv"])
    if dx0.reshape(B * N, -1)[[0, 127, 128, 1000]].float().abs().max():
        raise AssertionError("fused_ln_qkv_bwd: dx is not 0 on an all-zero "
                             "row of dqkv")
    for label in ("", "130 rows"):
        one, two = (oq.fused_ln_qkv_bwd_cuda(*qkv_bwd[label])
                    for _ in range(2))
        if not all(torch.equal(p, q) for p, q in zip(one, two)):
            raise AssertionError(f"fused_ln_qkv_bwd {label or 'flagship'}: "
                                 "two calls differ")
    log("kernels", "fused_ln_qkv_bwd: all-zero rows of dqkv give dx = 0; "
        "two calls bit-equal (dgamma and dbeta included) at the flagship "
        "and at 130 rows")
    # K8: dz bit-equal to plain's (dy itself at dropout 0), two calls
    # bit-equal, at the flagship and at 130 rows.
    for label, dy_ in (("flagship", dy), ("130 rows", dy_130)):
        for rate in (DROPOUT, 0.0):
            one, two = (fused_outproj.fused_outproj_bwd_cuda(
                dy_, wout, dropout_rate=rate, seed=1234) for _ in range(2))
            _, dz_plain = fused_outproj.fused_outproj_bwd_plain(
                dy_, wout, dropout_rate=rate, seed=1234)
            if not torch.equal(one[1], dz_plain):
                raise AssertionError(f"fused_outproj_bwd {label} dropout "
                                     f"{rate}: dz differs from plain's")
            if not rate and one[1] is not dy_:
                raise AssertionError(f"fused_outproj_bwd {label}: dz at "
                                     "dropout 0 is not dy")
            if not all(torch.equal(p, q) for p, q in zip(one, two)):
                raise AssertionError(f"fused_outproj_bwd {label} dropout "
                                     f"{rate}: two calls differ")
    log("kernels", f"fused_outproj_bwd: dz bit-equal to plain at dropout "
        f"{DROPOUT} and dy itself at 0; two calls bit-equal at the flagship "
        "and at 130 rows")
    del mlp8_more, mlp_more, mlp_zero, x0, y0, one, two, bwd_more, got0, dy0
    del qkv8_more, qkv_bwd, dqkv0, dx0, qkv_more, served, dz_plain
    del out8_more, attn0, out_130, dy_130
    attention_device_times(results, qkv, qkv_h, card)
    qkv_device_times(results, (x, *ln, wqkv, HEADS, DIM_HEAD), card)
    int8_qkv_device_times(results, (x, *ln, *qkv8, HEADS, DIM_HEAD), card)
    int8_mlp_device_times(results, (x, *ln, *mlp8), card)
    int8_attention_device_times(results, qkv, card)
    mlp_device_times(results, mlp_args, card)
    mlp_bwd_device_times(results, bwd_args, card)
    qkv_bwd_device_times(results, (dqkv, x, ln[0], wqkv), card)
    outproj_device_times(results, card)
    pool_device_times(results, card)
    return results


def _width_operands(rng, b: int, dim: int, heads: int, dh: int, hid: int
                    ) -> dict:
    """Seeded operands of one block at (dim, heads x dh, hid), batch b x N
    tokens, as the kernel phase makes them for the flagship."""
    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device="cuda")

    def w(out_f, in_f):                      # nn.Linear's default range
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    inner = heads * dh
    return dict(
        x=t(b, N, dim), ln=(t(dim, scale=0.1, dtype=torch.float32, offset=1.0),
                            t(dim, scale=0.1, dtype=torch.float32)),
        wqkv=w(3 * inner, dim), wout=w(dim, inner),
        bout=t(dim, scale=0.03, dtype=torch.float32), attn=t(b, N, inner),
        w1=w(hid, dim), b1=t(hid, scale=0.03, dtype=torch.float32),
        w2=w(dim, hid), b2=t(dim, scale=0.02, dtype=torch.float32),
        qkv=[t(b, N, heads, dh) for _ in range(3)], do=t(b, N, heads, dh),
        dqkv=torch.cat([t(b, N, inner, scale=0.1) for _ in range(3)],
                       dim=2),
        dy=t(b, N, dim, scale=0.1))


def widths_phase(card: str) -> None:
    """Every ViT width of the matrix (models/vit3d.py WIDTHS) at batch 2 x
    1001 tokens through K1-K13 against the plain versions, with the kernel
    phase's tolerances (K11 bit for bit), dropout 0.1 where an op has it;
    K4's, K9's, K2's, K10's, K7's, K11's, K3's and K8's plans (scratch and
    shared memory) against the kernels' own counts; K4 and K9 at ViT-H (dim
    1280, 16 heads of 80, mlp 5120), which the wmma K9 refused, against
    plain; K2, K10, K7, K3, K11 and K8 at ViT-H, at dim 1536 / inner 1536
    and at dim 2048 / inner 2048, which their wmma versions refused,
    against plain;
    then K4 and K9 timed at batch 8 at the ViT-B, ViT-L, ViT-H and flagship
    widths."""
    import ctypes

    from neurovit_tpu_torch.models.vit3d import WIDTHS
    from neurovit_tpu_torch.ops import _build
    from neurovit_tpu_torch.ops import flash_attention as fa
    from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv
    from neurovit_tpu_torch.ops import int8_serving as q8

    lib = _build.library()
    scratch, smem = lib.nvt_fused_mlp_scratch_bytes, lib.nvt_fused_mlp_smem_bytes
    bwd_scratch = lib.nvt_fused_mlp_bwd_scratch_bytes
    bwd_smem = lib.nvt_fused_mlp_bwd_smem_bytes
    qkv_scratch = lib.nvt_int8_qkv_scratch_bytes
    qkv_smem = lib.nvt_int8_qkv_smem_bytes
    k7_scratch = lib.nvt_fused_ln_qkv_bwd_scratch_bytes
    k7_smem = lib.nvt_fused_ln_qkv_bwd_smem_bytes
    k2_scratch = lib.nvt_fused_ln_qkv_fwd_scratch_bytes
    k2_smem = lib.nvt_fused_ln_qkv_fwd_smem_bytes
    k11_scratch = lib.nvt_int8_outproj_scratch_bytes
    k11_smem = lib.nvt_int8_outproj_smem_bytes
    k3_smem = lib.nvt_fused_outproj_smem_bytes
    k8_smem = lib.nvt_fused_outproj_bwd_smem_bytes
    for fn in (scratch, bwd_scratch, qkv_scratch, k7_scratch, k2_scratch,
               k11_scratch):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    for fn in (smem, bwd_smem, qkv_smem, k7_smem, k2_smem, k11_smem,
               k3_smem, k8_smem):
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 2

    def check_outproj_plans(what: str, m: int, dim: int, inner: int) -> None:
        """K11's plan (scratch, the GEMM's shared memory), K3's and K8's
        (their GEMM's shared memory) against the kernels' own counts."""
        plan8 = q8.int8_outproj_plan(m, dim, inner)
        counted = (k11_scratch(m, dim, inner), k11_smem(m, dim),
                   k3_smem(m, dim), k8_smem(m, inner))
        mine = (plan8.scratch_bytes, plan8.launches[1][3],
                fused_outproj.outproj_plan(m, dim, inner).launches[0][3],
                fused_outproj.outproj_bwd_plan(m, dim, inner,
                                               DROPOUT).launches[1][3])
        if counted != mine:
            raise AssertionError(
                f"{what}: K11's, K3's and K8's plans count (K11's scratch "
                f"and shared memory, K3's and K8's shared memory) {mine} "
                f"bytes, the kernels {counted}")

    rng = np.random.default_rng(SEED + 6)
    bf = torch.bfloat16
    for name, (dim, heads, dh, hid) in WIDTHS.items():
        plan = fused_mlp.mlp_plan(2 * N, dim, hid)
        counted = (scratch(2 * N, dim, hid), smem(2 * N, hid),
                   smem(2 * N, dim))
        mine = (plan.scratch_bytes, plan.launches[1][3], plan.launches[2][3])
        if counted != mine:
            raise AssertionError(f"{name}: K4's plan counts (scratch, fc1's "
                                 f"and fc2's shared memory) {mine} bytes, "
                                 f"the kernel {counted}")
        bplan = fused_mlp.mlp_bwd_plan(2 * N, dim, hid)
        counted = (bwd_scratch(2 * N, dim, hid), bwd_smem(2 * N, hid),
                   bwd_smem(2 * N, dim))
        theirs = (bplan.scratch_bytes, bplan.launches[1][3],
                  bplan.launches[2][3])
        if counted != theirs:
            raise AssertionError(f"{name}: K9's plan counts (scratch, the "
                                 f"hidden and du passes' shared memory) "
                                 f"{theirs} bytes, the kernel {counted}")
        k7plan = fused_qkv.qkv_bwd_plan(2 * N, dim, heads * dh)
        counted = (k7_scratch(2 * N, dim, heads * dh), k7_smem(2 * N, dim))
        if counted != (k7plan.scratch_bytes, k7plan.launches[1][3]):
            raise AssertionError(
                f"{name}: K7's plan counts (scratch, the du pass's shared "
                f"memory) {(k7plan.scratch_bytes, k7plan.launches[1][3])} "
                f"bytes, the kernel {counted}")
        k2plan = fused_qkv.qkv_plan(2 * N, dim, heads * dh)
        counted = (k2_scratch(2 * N, dim, heads * dh),
                   k2_smem(2 * N, heads * dh))
        if counted != (k2plan.scratch_bytes, k2plan.launches[1][3]):
            raise AssertionError(
                f"{name}: K2's plan counts (serving scratch, the GEMM's "
                f"shared memory) {(k2plan.scratch_bytes, k2plan.launches[1][3])}"
                f" bytes, the kernel {counted}")
        check_outproj_plans(name, 2 * N, dim, heads * dh)
        qplan = q8.qkv_plan(2 * N, dim, heads * dh)
        counted = (qkv_scratch(2 * N, dim, heads * dh),
                   qkv_smem(2 * N, heads * dh))
        if counted != (qplan.scratch_bytes, qplan.launches[1][3]):
            raise AssertionError(
                f"{name}: K10's plan counts (scratch, the GEMM's shared "
                f"memory) {(qplan.scratch_bytes, qplan.launches[1][3])} "
                f"bytes, the kernel {counted}")
        p = _width_operands(rng, 2, dim, heads, dh, hid)
        x, ln, (q, k, v), do = p["x"], p["ln"], p["qkv"], p["do"]
        wqkv, wout = p["wqkv"].to(bf), p["wout"].to(bf)
        w1, w2 = p["w1"].to(bf), p["w2"].to(bf)
        mlp = (x, *ln, w1, p["b1"], w2, p["b2"])
        att = {"scale": dh ** -0.5, "n_valid": N_VALID_MASKED,
               "dropout_rate": DROPOUT, "seed": 11}
        drop = {"dropout_rate": DROPOUT, "seed": 12}
        mdrop = {"dropout_rate": DROPOUT, "seeds": (13, 14)}
        o, lsum = fa.flash_attention_plain(q, k, v, return_stats=True, **att)
        _, h = fused_mlp.fused_mlp_block_plain(*mlp, return_h=True, **mdrop)
        qh, kh, vh, oh, doh = (a.transpose(1, 2).contiguous()
                               for a in (q, k, v, o, do))
        qkv8 = q8.quantize_weight(p["wqkv"])
        out8 = q8.quantize_weight(p["wout"])
        mlp8 = (*q8.quantize_weight(p["w1"]), p["b1"],
                *q8.quantize_weight(p["w2"]), p["b2"])
        i8att = {"scale": dh ** -0.5, "n_valid": N_VALID_MASKED}

        def both(fn_name, *args, module=None, **kw):
            return (lambda: getattr(module, fn_name + "_cuda")(*args, **kw),
                    lambda: getattr(module, fn_name + "_plain")(*args, **kw))

        cases = [
            ("K1", *both("flash_attention", q, k, v, module=fa,
                         return_stats=True, **att)),
            ("K2", *both("fused_ln_qkv", x, *ln, wqkv, heads, dh,
                         module=fused_qkv, return_u=True)),
            ("K3", *both("fused_outproj_residual", x, p["attn"], wout,
                         p["bout"], module=fused_outproj, **drop)),
            ("K4", *both("fused_mlp_block", *mlp, module=fused_mlp,
                         return_h=True, **mdrop)),
            ("K5", *both("flash_attention_bwd", q, k, v, o, do, lsum,
                         module=fa, **att), True, ()),
            ("K6", *both("flash_attention_bhnd", qh, kh, vh, module=fa,
                         return_stats=True, **att)),
            ("K6 bwd", *both("flash_attention_bhnd_bwd", qh, kh, vh, oh, doh,
                             lsum, module=fa, **att), True, ()),
            ("K7", *both("fused_ln_qkv_bwd", p["dqkv"], x, ln[0], wqkv,
                         module=fused_qkv), True, (1, 2)),
            ("K8", *both("fused_outproj_bwd", p["dy"], wout,
                         module=fused_outproj, **drop), True, ()),
            ("K9", *both("fused_mlp_bwd", p["dy"], x, h, *ln, w1, w2,
                         module=fused_mlp, **mdrop), True, (5, 6)),
            ("K10", *both("int8_ln_qkv", x, *ln, *qkv8, heads, dh,
                          module=q8)),
            ("K11", *both("int8_outproj_residual", x, p["attn"], *out8,
                          p["bout"], module=q8), False, (), "exact"),
            ("K12", *both("int8_mlp_block", x, *ln, *mlp8, module=q8)),
            ("K13", *both("int8_flash_attention", q, k, v, module=q8,
                          **i8att)),
        ]
        worst = {}
        for label, kernel, plain, *check in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            worst[label], _ = compare(f"widths {name} {label}", got, want,
                                      *check)
            del got, want
        log("widths", f"{name}: dim {dim}, {heads} heads x {dh}, mlp {hid} "
            f"(K4 grids {[g for _, g, _, _ in plan.launches]}, "
            f"{plan.scratch_bytes} B of scratch, {mine[1:]} B of shared "
            f"memory a GEMM block); K1-K13 "
            f"against plain at B=2 N={N}, max abs err "
            f"{max(worst.values()):.3e} ({max(worst, key=worst.get)})")
        del p, o, lsum, h, qh, kh, vh, oh, doh, cases

    # K4 and K9 at ViT-H, which the wmma K9 refused (its LayerNorm rows sat
    # in one warp's registers), against plain at batch 2.
    vit_h = (1280, 16, 80, 5120)
    p = _width_operands(rng, 2, vit_h[0], *vit_h[1:])
    mlp = (p["x"], *p["ln"], p["w1"].to(bf), p["b1"], p["w2"].to(bf),
           p["b2"])
    mdrop = {"dropout_rate": DROPOUT, "seeds": (13, 14)}
    got = fused_mlp.fused_mlp_block_cuda(*mlp, return_h=True, **mdrop)
    compare("widths vit_h K4", got, fused_mlp.fused_mlp_block_plain(
        *mlp, return_h=True, **mdrop))
    bwd = (p["dy"], p["x"], got[1], *p["ln"], mlp[3], mlp[5])
    err, _ = compare("widths vit_h K9",
                     fused_mlp.fused_mlp_bwd_cuda(*bwd, **mdrop),
                     fused_mlp.fused_mlp_bwd_plain(*bwd, **mdrop), True,
                     (5, 6))
    log("widths", f"vit_h: dim 1280, 16 heads x 80, mlp 5120; K4 and K9 "
        f"at dropout {DROPOUT} against plain at B=2 N={N}, K9 max abs err "
        f"{err:.3e}")
    del p, mlp, got, bwd
    # K2, K10, K7, K3, K11 and K8 at the widths their wmma versions refused
    # (K10's, K7's and K11's rows sat in one warp's registers, K2's u block,
    # K3's a block and K8's dz block in shared memory up to dim or inner
    # 1536): ViT-H, dim 1536 / inner 1536 and dim 2048 / inner 2048, at
    # batch 2 and at 130 rows, against plain (K3 and K8 at dropout 0.1, K8's
    # dz and K11 bit for bit).
    for dim, heads, dh in ((1280, 16, 80), (1536, 24, 64), (2048, 16, 128)):
        p = _width_operands(rng, 2, dim, heads, dh, 16)
        qkv8 = q8.quantize_weight(p["wqkv"])
        out8 = q8.quantize_weight(p["wout"])
        wqkv, wout = p["wqkv"].to(bf), p["wout"].to(bf)
        drop = {"dropout_rate": DROPOUT, "seed": 12}
        for m in (2 * N, 130):
            check_outproj_plans(f"dim {dim} inner {heads * dh}", m, dim,
                                heads * dh)
        worst = {"K2": [], "K10": [], "K7": [], "K3": [], "K11": [],
                 "K8": []}
        for label, rows in ((f"B=2 N={N}", (slice(None),)),
                            ("130 rows", (slice(0, 1), slice(0, 130)))):
            x = p["x"][rows].contiguous()
            k2 = (x, *p["ln"], wqkv, heads, dh)
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K2 "
                             f"{label}",
                             fused_qkv.fused_ln_qkv_cuda(*k2, return_u=True),
                             fused_qkv.fused_ln_qkv_plain(*k2, return_u=True))
            worst["K2"].append(err)
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K10 "
                             f"{label}",
                             q8.int8_ln_qkv_cuda(x, *p["ln"], *qkv8, heads,
                                                 dh),
                             q8.int8_ln_qkv_plain(x, *p["ln"], *qkv8, heads,
                                                  dh))
            worst["K10"].append(err)
            k7 = (p["dqkv"][rows].contiguous(), x, p["ln"][0], wqkv)
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K7 "
                             f"{label}", fused_qkv.fused_ln_qkv_bwd_cuda(*k7),
                             fused_qkv.fused_ln_qkv_bwd_plain(*k7), True,
                             (1, 2))
            worst["K7"].append(err)
            out = (x, p["attn"][rows].contiguous())
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K3 "
                             f"{label}",
                             fused_outproj.fused_outproj_residual_cuda(
                                 *out, wout, p["bout"], **drop),
                             fused_outproj.fused_outproj_residual_plain(
                                 *out, wout, p["bout"], **drop))
            worst["K3"].append(err)
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K11 "
                             f"{label}",
                             q8.int8_outproj_residual_cuda(*out, *out8,
                                                           p["bout"]),
                             q8.int8_outproj_residual_plain(*out, *out8,
                                                            p["bout"]),
                             mode="exact")
            worst["K11"].append(err)
            dy = p["dy"][rows].contiguous()
            got = fused_outproj.fused_outproj_bwd_cuda(dy, wout, **drop)
            want = fused_outproj.fused_outproj_bwd_plain(dy, wout, **drop)
            err, _ = compare(f"widths dim {dim} inner {heads * dh} K8 "
                             f"{label}", got, want, True, ())
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"widths dim {dim} K8 {label}: dz "
                                     "differs from plain's")
            worst["K8"].append(err)
        grids = [plan_of(2 * N, dim, heads * dh).launches[1][1]
                 for plan_of in (fused_qkv.qkv_plan, q8.qkv_plan,
                                 fused_qkv.qkv_bwd_plan,
                                 q8.int8_outproj_plan)]
        k8_grid = fused_outproj.outproj_bwd_plan(2 * N, dim, heads * dh,
                                                 DROPOUT).launches[1][1]
        log("widths", f"dim {dim}, {heads} heads x {dh}: K2, K10, K7, K3 "
            f"(dropout {DROPOUT}), K11 and K8 (dropout {DROPOUT}) against "
            f"plain at B=2 N={N} and at 130 rows, max abs err "
            + ", ".join(f"{k} {max(v):.3e}" for k, v in worst.items())
            + f" (GEMM grids K2 {grids[0]}, K10 {grids[1]}, K7 {grids[2]}, "
            f"K11 and K3 {grids[3]}, K8 {k8_grid})")
        del p, qkv8, wqkv, k2, k7, out8, wout, out, dy, got, want
    # K4 and K9 at ViT-B, ViT-L and ViT-H (K4's widest tiles, K9's widest
    # rows) beside the flagship.
    for name, (dim, heads, dh, hid) in (
            *((n, WIDTHS[n]) for n in ("flagship", "vit_b", "vit_l")),
            ("vit_h", vit_h)):
        p = _width_operands(rng, B, dim, heads, dh, hid)
        mlp = (p["x"], *p["ln"], p["w1"].to(bf), p["b1"], p["w2"].to(bf),
               p["b2"])
        _, h = fused_mlp.fused_mlp_block_cuda(*mlp, return_h=True)
        k4 = cuda_ms(lambda: fused_mlp.fused_mlp_block_cuda(*mlp))
        k9 = cuda_ms(lambda: fused_mlp.fused_mlp_bwd_cuda(
            p["dy"], p["x"], h, *p["ln"], mlp[3], mlp[5],
            dropout_rate=DROPOUT, seeds=(13, 14)))
        ops = {"bf16": 4 * B * N * dim * hid}
        b4, _ = bound(nbytes(*mlp), nbytes(p["x"]), ops)
        b9, _ = bound(nbytes(p["dy"], p["x"], h, *p["ln"], mlp[3], mlp[5]),
                      3 * nbytes(p["x"]) + 2 * nbytes(h), ops)
        log("widths", f"{name} at B={B} N={N}: K4 {k4:.4f} ms (bound "
            f"{b4:.4f}), K9 dropout {DROPOUT} {k9:.4f} ms (bound {b9:.4f}); "
            f"{card}")
        del p, mlp, h


def probes_phase(card: str, counters: dict) -> tuple:
    """The probe scripts' main paths on the card with the launch counts of
    each (scripts/torch_dropout_bench.py at [32 * 1001, 2048] bf16, and
    scripts/torch_int8_gemm_bench.py at its seven shapes); then K16 forward
    and backward bit-equal to the plain version with its keep fraction
    within 4 sigma of the quantized keep, and at each GEMM shape K17 int8
    and K18 bit-equal and K17 bf16 within K 2^-23 sum|a||b|, each timed by
    CUDA events beside its plain version and its library call (for K17 bf16
    ``torch.mm`` with f32 out where this PyTorch has it, else
    ``torch.matmul``), and by the profiler's device time, with its rate and
    its transpose step's share of that time. The summary keeps fc1's
    numbers and the largest error. Returns (stats, launches)."""
    import torch.nn.functional as F

    from neurovit_tpu_torch.ops import dropout as k16
    from neurovit_tpu_torch.ops import int8_gemm as k17

    drop_bench = script("torch_dropout_bench")
    gemm_bench = script("torch_int8_gemm_bench")
    gemm_times = script("torch_gemm_device_times")
    for fn in counters.values():
        fn.launches = 0
    times = drop_bench.run("cuda", iters=10)
    rows = gemm_bench.run("cuda", iters=10)
    torch.cuda.synchronize()
    launches = {name: counters[name].launches for name in PROBE_KERNELS}
    log("probes", f"torch_dropout_bench at {DROPOUT_SHAPE}: "
        + ", ".join(f"{key} {val:.4f}" for key, val in times.items()))
    for row in rows:
        log("probes", "torch_int8_gemm_bench " + gemm_bench.line(row))
    log("probes", f"launches of the two probes' runs: {launches}")
    _check_counts("the probes", {name: counters[name].launches
                                 for name in counters},
                  {name: launches[name] if name in PROBE_KERNELS else 0
                   for name in counters})

    stats = {}
    threshold, keep = k16.keep_threshold32(DROPOUT)
    q_keep = threshold / 2.0 ** 32
    x = torch.tensor(np.random.RandomState(0).randn(*DROPOUT_SHAPE),
                     dtype=torch.bfloat16, device="cuda")
    g = torch.tensor(np.random.RandomState(1).randn(*DROPOUT_SHAPE),
                     dtype=torch.bfloat16, device="cuda")
    xr = x.clone().requires_grad_()
    y = k16.dropout(xr, DROPOUT, 1234)
    y.backward(g)
    err = 0.0
    for what, got, want in (("forward", y.detach(),
                             k16.dropout_plain(x, DROPOUT, 1234)),
                            ("backward", xr.grad,
                             k16.dropout_plain(g, DROPOUT, 1234))):
        err = max(err, compare(f"dropout {what}", got, want, mode="exact")[0])
    kept = float((y != 0).float().mean())
    sigma = (q_keep * (1 - q_keep) / x.numel()) ** 0.5
    if abs(kept - q_keep) > 4 * sigma:
        raise AssertionError(f"K16 keeps {kept}, expected {q_keep} +- "
                             f"{4 * sigma}")
    ms = cuda_ms(lambda: k16.dropout_cuda(x, DROPOUT, 1234))
    plain_ms = cuda_ms(lambda: k16.dropout_plain(x, DROPOUT, 1234))
    bound_ms, bound_by = bound(nbytes(x), nbytes(x), {})
    stats["dropout"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: F.dropout(x, DROPOUT, training=True))}
    log("probes", f"dropout at {DROPOUT_SHAPE} bf16: forward and backward "
        f"equal to plain bit for bit, keep fraction {kept:.6f} (quantized "
        f"keep {q_keep:.6f}, 4 sigma {4 * sigma:.1e}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, F.dropout "
        f"{stats['dropout']['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
        f"by {bound_by}; {card}")
    del x, g, xr, y

    for i, (name, m, k, n) in enumerate(gemm_bench.SHAPES):
        ops = gemm_bench.operands(m, k, n, "cuda")
        a8, b8, sa, sb = ops["a8"], ops["b8"], ops["sa"], ops["sb"]
        abf, bbf = ops["abf"], ops["bbf"]
        c8 = k17.gemm_int8_cuda(a8, b8)
        dq = k17.dynquant_matmul_cuda(a8, b8, sa, sb)
        cbf = k17.gemm_bf16_cuda(abf, bbf)
        compare(f"gemm_int8 {name}", c8, k17.blocked_matmul_plain(a8, b8),
                mode="exact")
        compare(f"dynquant_matmul {name}", dq,
                k17.dynquant_matmul_plain(a8, b8, sa, sb), mode="exact")
        want = k17.blocked_matmul_plain(abf, bbf)
        tol = k * 2.0 ** -23 * (abf.float().abs() @ bbf.float().abs())
        bf_err = float((cbf - want).abs().max())
        if not ((cbf - want).abs() <= tol).all():
            raise AssertionError(f"gemm_bf16 {name}: outside K 2^-23 "
                                 f"sum|a||b| (max abs err {bf_err:.3e})")
        flop = 2 * m * k * n
        lib_bf16 = (gemm_bench.library_mm_f32(abf, bbf)
                    or (lambda: torch.matmul(abf, bbf)))
        timed = {
            "gemm_bf16": (lambda: k17.gemm_bf16_cuda(abf, bbf),
                          lambda: k17.blocked_matmul_plain(abf, bbf),
                          lib_bf16, (abf, bbf), cbf, "bf16", bf_err),
            "gemm_int8": (lambda: k17.gemm_int8_cuda(a8, b8),
                          lambda: k17.blocked_matmul_plain(a8, b8),
                          gemm_bench.library_int_mm(a8, b8), (a8, b8), c8,
                          "int8", 0.0),
            "dynquant_matmul": (lambda: k17.dynquant_matmul_cuda(a8, b8, sa,
                                                                 sb),
                                lambda: k17.dynquant_matmul_plain(a8, b8, sa,
                                                                  sb),
                                None, (a8, b8, sa, sb), dq, "int8", 0.0),
        }
        for kname, (kernel, plain, lib, ins, out, kind, err) in timed.items():
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            lib_ms = cuda_ms(lib) if lib is not None else None
            bound_ms, bound_by = bound(nbytes(*ins), nbytes(out), {kind: flop})
            if i == 0:
                stats[kname] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": lib_ms}
            else:
                stats[kname]["max_abs_err"] = max(
                    stats[kname]["max_abs_err"], err)
            dev = gemm_times.device_us(kernel, 10)
            dev_ms = sum(dev.values()) / 1e3
            step_ms = sum(t for key, t in dev.items()
                          if "transpose" in key) / 1e3
            unit = "TFLOP/s" if kind == "bf16" else "TOP/s"
            dev_text = "device time not measured (no kernels traced)"
            if dev:
                rate = flop / dev_ms / 1e9
                dev_text = (f"device {dev_ms:.4f} ms ({rate:.1f} {unit}, "
                            f"bound {bound_ms / dev_ms:.1%} of it), transpose "
                            f"step {step_ms / dev_ms:.1%} of it")
            lib_text = "none"
            if lib is not None:
                lib_dev = sum(gemm_times.device_us(lib, 10).values()) / 1e3
                lib_text = f"{lib_ms:.4f} ms, device " + (
                    f"{lib_dev:.4f} ms" if lib_dev else "not measured")
            log("probes", f"{kname} {name} [{m}, {k}] x [{k}, {n}]: kernel "
                f"{ms:.4f} ms, {dev_text}; plain {plain_ms:.4f} ms; library "
                f"{lib_text}; bound {bound_ms:.4f} ms by {bound_by}; max abs "
                f"err {err:.3e}; {card}")
        del ops, a8, b8, sa, sb, abf, bbf, c8, dq, cbf, want, tol, timed
    return stats, launches


def widths_model_phase(config, workdir: str, counters: dict) -> None:
    """The verify recipe's smoke model (dim 64, 4 heads of 16, MLP 128,
    depth 2, 20^3 synthetic cubes) trained for an epoch in bf16 on cuda
    through ``python -m neurovit_tpu_torch.main``'s main(), every bf16
    forward and backward kernel launched; then a ViT-B-width model (dim
    768, 12 heads of 64, MLP 3072, depth cut to 4, 90^3 volumes) served by
    Predictor against the CPU plain path."""
    import yaml

    from neurovit_tpu_torch import main as cli
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.serving import Predictor

    runs = os.path.join(workdir, "smoke_runs")
    smoke = dict(config, DATASET_NAME="gradcam", DATASET_GENERATE=True,
                 GRADCAM_NUM_SAMPLES=80,
                 GRADCAM_TRAIN_PATH=os.path.join(runs, "train.pkl"),
                 GRADCAM_VAL_PATH=os.path.join(runs, "val.pkl"),
                 TRAINING_VIT_INPUT_SIZE=20, TRAINING_VIT_PATCH_SIZE=5,
                 MODEL_VIT_DIM=64, MODEL_VIT_DEPTH=2, MODEL_VIT_HEADS=4,
                 MODEL_VIT_DIM_HEAD=16, MODEL_VIT_MLP_DIM=128,
                 TRAINING_EPOCHS=1, TRAINING_BATCH_SIZE=8,
                 TRAINING_PRECISION="bf16", TRAINING_LEARNING_RATE=1e-3,
                 TRAINING_NUM_WORKERS=2, GRADCAM_SLICE_IDX=10,
                 GLOBAL_OUTPUT_DIR=runs,
                 BEST_MODEL_PATH=os.path.join(runs, "best_model.pkl"))
    path = os.path.join(workdir, "smoke.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(smoke, f)
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["smoke", "--wandb", "false", "--config", path])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    text = out.getvalue()
    lines = [ln.expandtabs(1) for ln in text.splitlines()]
    for line in lines[-6:]:
        log("widths", f"smoke CLI: {line}")
    if "train_loss" not in text or "MODEL SAVED to" not in text:
        raise AssertionError("the smoke model's CLI run printed no training "
                             "or no checkpoint")
    block = [name for name, _, _ in KERNELS if name not in OFF_BLOCK_KERNELS]
    if any(launches[name] == 0 for name in block) or any(
            launches[name] for name in OFF_BLOCK_KERNELS):
        raise AssertionError(f"the smoke CLI run launched {launches}")
    log("widths", f"smoke model (64, 4 x 16, 128) trained for an epoch in "
        f"bf16 on cuda through the CLI in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")

    vit_b = dict(config, MODEL_VIT_DIM=768, MODEL_VIT_HEADS=12,
                 MODEL_VIT_DIM_HEAD=64, MODEL_VIT_MLP_DIM=3072,
                 MODEL_VIT_DEPTH=4)
    ckpt = os.path.join(workdir, "vit_b.pt")
    torch.save(NeuroEncoder(vit_b, device="cpu", seed=SEED).state_dict(),
               ckpt)
    predictor = Predictor.from_checkpoint(vit_b, ckpt, batch_size=32,
                                          device="cuda")
    slice_phase(vit_b, ckpt, predictor, np.random.default_rng(SEED + 7),
                phase="widths")
    del predictor


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
    from neurovit_tpu_torch.data import nifti
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


def param_grads(config, device: str, phase: str) -> tuple:
    """Loss and every parameter gradient (f32, on the CPU) of the
    full-width model made from SEED on ``device``, at batch 2 in train mode
    with dropout on (the ViT's Philox masks are the same bits on both
    devices)."""
    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.models import NeuroEncoder

    config = dict(config, TRAINING_DROPOUT=DROPOUT)
    model = NeuroEncoder(config, device=device, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    vols = torch.from_numpy(_volumes(rng, 2, config["TRAINING_VIT_INPUT_SIZE"]))
    labels = torch.tensor([0, 1])
    t0 = time.perf_counter()
    loss = nn.softmax_cross_entropy(
        model(vols.to(device), train=True, seed=SEED), labels.to(device))
    loss.backward()
    value = float(loss.detach())
    grads = {name: p.grad.float().cpu() for name, p in model.named_parameters()}
    for name, g in grads.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient on {device} is not finite")
    log(phase, f"{config.get('TRAINING_PRECISION', 'bf16')} {device}: loss "
        f"{value:.6f}, forward + backward "
        f"{time.perf_counter() - t0:.1f} s host clock")
    return value, grads


def grad_errs(got: dict, want: dict) -> dict:
    """Each gradient's relative Frobenius error, ``got`` against ``want``."""
    return {name: float((got[name] - c).norm() / c.norm().clamp_min(1e-30))
            for name, c in want.items()}


def err_text(errs: dict) -> str:
    worst = max(errs, key=errs.get)
    return (f"{len(errs)} parameter gradients, relative Frobenius error "
            f"worst {worst} at {errs[worst]:.3e}, median "
            f"{float(np.median(list(errs.values()))):.3e}")


def hold_losses(losses: dict) -> None:
    if abs(losses["cuda"] - losses["cpu"]) > 2e-2 * abs(losses["cpu"]):
        raise AssertionError(f"losses differ: {losses}")


def grad_phase(config, phase: str = "grad") -> dict:
    """Loss and every parameter gradient of the full-width model on cuda
    against the same weights on the CPU plain path, held to GRAD_RTOL.
    Returns the gradients by device."""
    losses, grads = {}, {}
    for dev in ("cuda", "cpu"):
        losses[dev], grads[dev] = param_grads(config, dev, phase)
    errs = grad_errs(grads["cuda"], grads["cpu"])
    log(phase, f"{config.get('TRAINING_PRECISION', 'bf16')}: "
        f"{err_text(errs)} (held to {GRAD_RTOL})")
    hold_losses(losses)
    if max(errs.values()) > GRAD_RTOL:
        raise AssertionError(f"gradient relative Frobenius error above "
                             f"{GRAD_RTOL}: {err_text(errs)}")
    return grads


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
        want = (0 if name in OFF_BLOCK_KERNELS
                else depth * (steps[0] if name.endswith("_bwd")
                              else forwards[0]))
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
    and their mean; then a profiler split of each forward."""
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
        for quant in ("int8", "bf16"):
            profile_split("rate", f"{quant} forward",
                          lambda: models[quant](vols),
                          float(np.mean(times[quant])))


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
    from neurovit_tpu_torch.data import nifti
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


def _conv_gflop(model, size: int) -> float:
    """Forward GFLOP of one volume through the ResNet's convolutions (2 per
    multiply-add), counted from the shapes of one forward."""
    from neurovit_tpu_torch.models import resnet3d
    total = [0]
    conv = resnet3d.conv3d

    def counting(x, weight, stride=1, padding=0):
        out = conv(x, weight, stride, padding)
        total[0] += 2 * out.numel() * weight[0].numel()
        return out

    resnet3d.conv3d = counting
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, size), device="cuda"))
    finally:
        resnet3d.conv3d = conv
    return total[0] / 1e9


def resnet_phase(config, workdir: str, card: str, counters: dict) -> dict:
    """The full-width ResNet-18 (the config with MODEL_VOLUME_ENCODER:
    resnet, seed 42): served, its gradients, a Trainer epoch served back,
    the train-step rate and the three CAMs (see the module docstring, phase
    13). Returns the launch counts of the train run."""
    import glob

    from neurovit_tpu_torch.explainability import gradcam_resnet as gr
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.training import Trainer
    from neurovit_tpu_torch.training import state_dict as sd

    pool, pool_bwd = RESNET_KERNELS
    cfg = dict(config, MODEL_VOLUME_ENCODER="resnet")
    size = cfg["TRAINING_VIT_INPUT_SIZE"]
    rng = np.random.default_rng(SEED + 8)
    ckpt = os.path.join(workdir, "resnet.pt")
    cpu = NeuroEncoder(cfg, device="cpu", seed=SEED)
    torch.save(cpu.state_dict(), ckpt)
    log("resnet", f"ResNet-{cpu.resnet_cfg.depth} at {size}^3, "
        f"{sum(p.numel() for p in cpu.parameters()) / 1e6:.2f} M "
        f"parameters, {cpu.compute_dtype}, seed {SEED}")

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    # Serving: Predictor (requests of 1, 3 and 32) and one HTTP /predict.
    predictor = Predictor.from_checkpoint(cfg, ckpt, batch_size=32,
                                          device="cuda")
    forwards = _count_forwards(predictor.model)
    reset()
    t0 = time.perf_counter()
    predictor.warmup()
    log("resnet", f"warmup of buckets {predictor.bucket_sizes}: "
        f"{time.perf_counter() - t0:.1f} s")
    slice_phase(cfg, ckpt, predictor, rng, phase="resnet")
    http_phase(predictor, rng, workdir, n_files=1, concurrent=False)
    serving = read()
    log("resnet", f"serving: {forwards[0]} forward calls; launches "
        f"{serving}")
    _check_counts("ResNet serving", serving, {
        name: forwards[0] if name == pool else 0 for name in counters})
    del predictor
    torch.cuda.empty_cache()

    # Gradients at batch 2 in train mode. f32: cuda against the CPU plain
    # path, held to GRAD_RTOL, with cuDNN's global TF32 flag at its default
    # (the port's convs turn it off themselves). bf16: each device against
    # the CPU's f32 gradients, the card held to BF16_GRAD_RATIO times the
    # plain path's error plus GRAD_RTOL.
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN's TF32 flag is not at its default")
    f32 = grad_phase(dict(cfg, TRAINING_PRECISION="f32"), phase="resnet")
    losses, bf16 = {}, {}
    for dev in ("cuda", "cpu"):
        losses[dev], bf16[dev] = param_grads(cfg, dev, "resnet")
    hold_losses(losses)
    errs = {dev: grad_errs(bf16[dev], f32["cpu"]) for dev in bf16}
    for dev in errs:
        log("resnet", f"bf16 {dev} against f32 cpu: {err_text(errs[dev])}")
    log("resnet", f"bf16 cuda against bf16 cpu: "
        f"{err_text(grad_errs(bf16['cuda'], bf16['cpu']))} (reported); "
        f"f32 cuda against f32 cpu above")
    for stat in (max, np.median):
        on_card, plain = (float(stat(list(errs[dev].values())))
                          for dev in ("cuda", "cpu"))
        if on_card > BF16_GRAD_RATIO * plain + GRAD_RTOL:
            raise AssertionError(
                f"bf16 gradients on cuda {on_card:.3e} from the f32 ones, "
                f"the CPU plain path's {plain:.3e} ({stat.__name__})")
    del f32, bf16
    torch.cuda.empty_cache()

    # Trainer.run(): one epoch of 4 train batches of 16 and 1 val batch.
    tcfg = _train_config(cfg, workdir, TRAINING_BATCH_SIZE=16,
                         GLOBAL_OUTPUT_DIR=os.path.join(workdir, "resnet"))
    model = NeuroEncoder(tcfg, device="cuda", seed=SEED)
    trainer = Trainer(tcfg, model, _SeededVolumes(64, size, SEED, "train"),
                      _SeededVolumes(16, size, SEED + 1, "val"))
    forwards, steps = _count_forwards(model), [0]
    step = trainer.train_step

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    trainer.train_step = counted_step
    out = io.StringIO()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    text = out.getvalue()
    for line in text.splitlines():
        log("resnet", line.expandtabs(1))
    for want in ("epoch 0\t| batch 3/4\t| train_loss: ",
                 "[VALIDATION] epoch 0\t| total_batch 0\t| val_loss ",
                 "MODEL SAVED to ."):
        if want not in text:
            raise AssertionError(f"Trainer.run() did not print {want!r}")
    log("counts", f"ResNet train run: {forwards[0]} forwards, {steps[0]} "
        f"backwards in {secs:.1f} s host clock; launches {launches}")
    _check_counts("the ResNet train run", launches, {
        name: forwards[0] if name == pool else steps[0] if name == pool_bwd
        else 0 for name in counters})
    pkl = glob.glob(os.path.join(tcfg["GLOBAL_OUTPUT_DIR"], "*",
                                 "model-e0.state_dict.pkl"))
    weights = sd.load(pkl[0])
    key = "resnet_3d.resnet.bn1."
    if (int(weights[key + "num_batches_tracked"]) != steps[0]
            or torch.equal(weights[key + "running_var"],
                           torch.ones_like(weights[key + "running_var"]))):
        raise AssertionError("the checkpoint lacks the moved running stats")
    served = Predictor.from_checkpoint(tcfg, pkl[0], batch_size=1,
                                       bucket_sizes=(), device="cuda")
    vol = _SeededVolumes(1, size, SEED + 2, "serve").sample(0)["volume"]
    _, probs = served(vol[None])
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(vol[None]).cuda()
                                   ).float(), -1).cpu().numpy()
    if not np.isfinite(probs).all() or np.abs(probs - want).max() > PROB_ATOL:
        raise AssertionError(f"served {probs} against the trainer's {want}")
    log("resnet", f"model-e0 (running stats after {steps[0]} steps) served "
        f"by Predictor: probs {probs[0].tolist()} (trainer's model in eval "
        f"{want[0].tolist()})")
    del served, trainer

    # Ten bf16 steps on one fixed batch of 8: the loss must fall.
    fcfg = dict(tcfg, TRAINING_DROPOUT=0.0, TRAINING_BATCH_SIZE=8)
    fixed = Trainer(fcfg, NeuroEncoder(fcfg, device="cuda", seed=SEED),
                    _SeededVolumes(8, size, SEED + 3, "fixed"),
                    _SeededVolumes(8, size, SEED + 3, "fixed"))
    fbatch, zyx, _ = next(fixed._device_prefetch(fixed.val_dataloader))
    losses = [float(fixed.train_step(fbatch, zyx)["loss"]) for _ in range(10)]
    log("resnet", f"fixed batch of 8, 10 bf16 steps at lr "
        f"{fcfg['TRAINING_LEARNING_RATE']}: losses "
        f"{[round(v, 5) for v in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the ResNet's loss did not fall: {losses}")
    del fixed, fbatch

    # The train-step rate at batch 64.
    batch = 64
    gflop = _conv_gflop(model, size)
    rcfg = _train_config(cfg, workdir, TRAINING_BATCH_SIZE=batch)
    ds = _SeededVolumes(batch, size, SEED + 4, "rate")
    rate = Trainer(rcfg, NeuroEncoder(rcfg, device="cuda", seed=SEED), ds, ds)
    dbatch, zyx, _ = next(rate._device_prefetch(rate.val_dataloader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rate.train_step(dbatch, zyx)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("resnet", f"train step at batch {batch}: {ms:.2f} ms median of 5 "
        f"(all {[round(t * 1e3, 2) for t in times]}), "
        f"{batch / ms * 1e3:.1f} vol/s, {3 * gflop * batch / ms:.1f} "
        f"TFLOP/s of convolutions ({gflop:.2f} GFLOP/vol forward, 3x for "
        f"the step), peak memory {peak:.2f} GiB; {card}")
    profile_split("resnet", "ResNet train step",
                  lambda: rate.train_step(dbatch, zyx), ms)
    del rate, dbatch
    torch.cuda.empty_cache()

    # The three CAMs of the trained model: launches, against the CPU plain
    # path at batch 1, and latency at batch 1 and 8.
    model.eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x1 = torch.from_numpy(_volumes(rng, 1, size)).cuda()
    for method in gr.METHODS:
        reset()
        cam, cls = gr.cam(model, x1, method)
        torch.cuda.synchronize()
        ran = read()
        _check_counts(f"one {method} CAM", ran, {
            name: 1 if name == pool else 0 for name in counters})
        _, cls_g, acts_g, grads_g = gr.layer4_acts_grads(model, x1)
        _, cls_c, acts_c, grads_c = gr.layer4_acts_grads(cpu, x1.cpu())
        raw_c = gr.raw_cam(method, acts_c, grads_c)
        err = _rel_err(gr.raw_cam(method, acts_g, grads_g), raw_c)
        final = gr.cam_to_volume(raw_c, x1.shape[1:])
        diff = float((final - cam.cpu()).abs().max())
        log("resnet", f"{method}: class {int(cls_g)} / cpu {int(cls_c)}, raw "
            f"CAM relative error {err:.3e} (tol {GRAD_RTOL}), maps differ by "
            f"at most {diff:.3e}; launches {ran}")
        if (int(cls_g) != int(cls_c) or err > GRAD_RTOL
                or cam.shape != (1, size, size, size)):
            raise AssertionError(f"{method}: cuda and cpu CAMs differ")
    for b in (1, 8):
        xb = torch.from_numpy(_volumes(rng, b, size)).cuda()
        for method in gr.METHODS:
            cam_ms = cuda_ms(lambda: gr.cam(model, xb, method), warmup=2,
                             runs=10)
            log("resnet", f"{method} at batch {b}: {cam_ms:.3f} ms, "
                f"{b / cam_ms * 1e3:.1f} maps/s; {card}")
        profile_split("resnet", f"layercam at batch {b}",
                      lambda: gr.cam(model, xb, "layercam"), cam_ms)
    return launches


# ---------------------------------------------------------------------------
# The 4D path: config4D's frozen flagship ViT over B·T volumes
# ---------------------------------------------------------------------------

# config4D's series: 140 timepoints of 90^3; the serving CLI's files are
# cut to 8 timepoints to keep them small.
SEQ_T = 140
CLI_T = 8
# Cached against recomputed training, per step loss: the JAX test's bound
# (tests/test_feature_cache_4d.py).
CACHE_LOSS_RTOL = 1e-5
# The int8 encoder's features against the bf16 encoder's: relative
# Frobenius error (tests/test_int8_serving.py's bound on model outputs).
INT8_FEAT_RTOL = 5e-2
# The temporal head and projection at f32, card against the CPU plain path.
HEAD_F32_ATOL = 1e-3
# One sequence through the whole bf16 model, card against the CPU, and the
# volume encoder's bf16 encodings (its logits) against the CPU's.
BF16_LOGIT_ATOL = 5e-2
# The full B·T fold is held against the CPU plain path at its first and
# last EDGE_T timepoints of each sequence: the first and last rows of the
# fold and the seam between the two sequences.
EDGE_T = 3
# The block kernels' backwards: a 4D phase launches none of them.
BACKWARD_KERNELS = ["flash_attention_bwd", "fused_ln_qkv_bwd",
                    "fused_outproj_bwd", "fused_mlp_bwd"]
BF16_BLOCK_KERNELS = ["flash_attention", "fused_ln_qkv",
                      "fused_outproj_residual", "fused_mlp_block"]


class _SeededSequences:
    """[size^3, T] series made lazily per index from a seed, the host never
    holding the corpus: a standard-normal volume plus a wave along x that
    moves with the timepoint (an affine change of a whole volume would
    vanish in the patch LayerNorm), its amplitude set by the label."""

    def __init__(self, n: int, size: int, t: int, seed: int, mode: str):
        self.n, self.size, self.t, self.seed, self.mode = n, size, t, seed, mode

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        label = idx % 2
        base = rng.standard_normal((self.size,) * 3, dtype=np.float32)
        x = np.arange(self.size, dtype=np.float32)[:, None]
        t = np.arange(self.t, dtype=np.float32)[None, :]
        wave = ((1 + label) * np.sin(0.2 * x + 0.15 * t)).astype(np.float32)
        return {"volume": base[..., None] + wave[:, None, None, :],
                "label": label, "subject": f"{self.mode}_{idx}",
                "timepoint": 0}


def _fourd_config(workdir: str, **extra) -> dict:
    """configs/config4D.yaml through the port's load_config, with one
    epoch's accumulation (2 micro-batches of 2 sequences make one update)
    and a workdir of its own."""
    from neurovit_tpu_torch.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configs", "config4D.yaml"))
    return {**cfg, "TRAINING_ACCUMULATION_STEP": 2, "TRAINING_EPOCHS": 2,
            "TRAINING_NUM_WORKERS": 4, "WANDB_ENABLED": False,
            "GLOBAL_OUTPUT_DIR": os.path.join(workdir, "runs4d"), **extra}


def _run_trainer(trainer, counters: dict, epochs=None) -> tuple:
    """Trainer.run() (or ``epochs`` of train + validate) with the launch
    counts set to 0 just before and read just after; returns (the
    per-step losses, the launch counts, the printed text)."""
    losses = []
    step = trainer.train_step

    def recorded(*args, **kwargs):
        m = step(*args, **kwargs)
        losses.append(float(m["loss"]))
        return m

    trainer.train_step = recorded
    out = io.StringIO()
    for fn in counters.values():
        fn.launches = 0
    with contextlib.redirect_stdout(out):
        if epochs is None:
            trainer.run()
        else:
            for epoch in range(epochs):
                trainer.train(epoch)
                trainer.validate(epoch)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    trainer.train_step = step
    if not np.isfinite(losses).all():
        raise AssertionError(f"4D losses are not finite: {losses}")
    return losses, launches, out.getvalue()


def _want(names: list, count: int, counters: dict) -> dict:
    return {name: count if name in names else 0 for name in counters}


def _encoder_forwards(model) -> list:
    """A one-element list counting the frozen ViT's forward calls."""
    return _count_forwards(model.volume_encoder.vit3d)


def _checkpoint(run_dir: str) -> str:
    import glob
    pkl = glob.glob(os.path.join(run_dir, "*", "model-e0.state_dict.pkl"))
    if len(pkl) != 1:
        raise AssertionError(f"no single model-e0 checkpoint: {pkl}")
    return pkl[0]


def _fold_against_cpu(model, cpu, x: torch.Tensor) -> None:
    """The card's encode_sequence of all B·T volumes of ``x`` against the
    CPU plain path on the first and last EDGE_T timepoints of each
    sequence: the encodings at the bf16 bound, and the ViT's last block
    output (the head's input, [N + 1, dim] a volume) by relative Frobenius
    error per volume, each volume's nearer its own CPU row than any other
    held volume's, so that a row offset in the fold shows."""
    b, t = x.shape[0], x.shape[-1]
    ts = list(range(EDGE_T)) + list(range(t - EDGE_T, t))
    rows = [i * t + j for i in range(b) for j in ts]
    acts = {}

    def keep(dev, index):
        def hook(_module, _args, out):
            acts[dev] = out[index].float().cpu().reshape(len(rows), -1)
        return hook

    index = torch.tensor(rows, device=x.device)
    for dev, m, vols in (("cuda", model, x), ("cpu", cpu, x[..., ts].cpu())):
        handle = m.volume_encoder.vit3d.transformer.register_forward_hook(
            keep(dev, index if dev == "cuda" else slice(None)))
        t0 = time.perf_counter()
        try:
            enc = m.encode_sequence(vols)
        finally:
            handle.remove()
        if dev == "cuda":
            got = enc[:, ts].cpu()
        else:
            want, cpu_s = enc, time.perf_counter() - t0
    diff = float((got - want).abs().max())
    errs = ((acts["cuda"] - acts["cpu"]).norm(dim=1)
            / acts["cpu"].norm(dim=1)).tolist()
    dist = torch.cdist(acts["cuda"], acts["cpu"])
    own = bool((dist.argmin(dim=1) == torch.arange(len(rows))).all())
    apart = torch.cdist(acts["cpu"], acts["cpu"]) / acts["cpu"].norm(
        dim=1, keepdim=True)
    apart.fill_diagonal_(float("inf"))
    log("4d", f"(d) the card's fold of {b} x {t} = {b * t} volumes against "
        f"the cpu plain path at timepoints {ts} of each sequence (rows "
        f"{rows}): encodings max diff {diff:.3e} (tol {BF16_LOGIT_ATOL}); "
        f"last block output relative errors {[round(e, 6) for e in errs]} "
        f"(tol {GRAD_RTOL}), each volume nearest its own cpu row {own}, "
        f"the nearest other held volume {float(apart.min()):.3e} apart; cpu "
        f"{cpu_s:.1f} s host clock")
    if not (bool(torch.isfinite(got).all()) and diff <= BF16_LOGIT_ATOL
            and max(errs) <= GRAD_RTOL and own):
        raise AssertionError("the 4D fold differs from the cpu plain path")


def fourd_phase(workdir: str, card: str, counters: dict) -> dict:
    """config4D's 4D path on the card (see the module docstring, phase
    16): (a) the bf16 encoder's Trainer, (b) the feature cache, (c) the
    int8 encoder, (d) parity, (e) serving, (f) timing, (g) the ResNet-18
    encoder in 4D. Returns the launch counts of its main-path runs,
    summed."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer
    from neurovit_tpu_torch.training import state_dict as sd

    phase = "4d"
    cfg = _fourd_config(workdir)
    size = cfg["TRAINING_VIT_INPUT_SIZE"]
    depth = cfg["MODEL_VIT_DEPTH"]
    total = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    # (a) The bf16 encoder: Trainer.run(), 2 epochs of 4 train and 2 val
    # sequences at batch 2, accumulation 2: one update an epoch.
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    log(phase, f"config4D: B {cfg['TRAINING_BATCH_SIZE']} x T {SEQ_T} of "
        f"{size}^3 = {cfg['TRAINING_BATCH_SIZE'] * SEQ_T} volumes a step "
        f"through the frozen ViT (dim {model.vit_cfg.dim}, depth {depth}), "
        f"{cfg['TRAINING_PRECISION']}; accumulation overridden 8 -> 2 so one "
        f"epoch of 4 sequences makes one update; temporal dropout "
        f"{model.temporal_cfg.dropout}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters, {model.param_count()[1]} trainable")
    encoder0 = {k: v.clone() for k, v in model.state_dict().items()
                if k.startswith("volume_encoder.")}
    head0 = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith("volume_encoder.")}
    train_ds = _SeededSequences(4, size, SEQ_T, SEED, "train4d")
    val_ds = _SeededSequences(2, size, SEQ_T, SEED + 1, "val4d")
    trainer = Trainer(cfg, model, train_ds, val_ds)
    forwards = _encoder_forwards(model)
    t0 = time.perf_counter()
    losses_a, launches, text = _run_trainer(trainer, counters)
    secs = time.perf_counter() - t0
    for line in text.splitlines():
        log(phase, line.expandtabs(1))
    _check_counts("the 4D bf16 run", launches,
                  _want(BF16_BLOCK_KERNELS, depth * forwards[0], counters))
    add(launches)
    state = model.state_dict()
    if any(not torch.equal(state[k], v) for k, v in encoder0.items()):
        raise AssertionError("the frozen encoder moved")
    if all(torch.equal(state[k], v) for k, v in head0.items()):
        raise AssertionError("the temporal head and projection did not move")
    if trainer.optimizer.steps != 2:
        raise AssertionError(f"{trainer.optimizer.steps} updates, expected 2")
    ckpt_a = _checkpoint(cfg["GLOBAL_OUTPUT_DIR"])
    log(phase, f"(a) bf16 encoder: 2 epochs ({len(losses_a)} micro-steps, "
        f"{trainer.optimizer.steps} updates, {forwards[0]} encoder forwards) "
        f"in {secs:.1f} s host clock, data made in the run; losses "
        f"{[round(v, 6) for v in losses_a]}; encoder bit-unchanged, head "
        f"moved; launches {launches}")

    # (b) The feature cache, persisted: precompute launches K1-K4, the
    # epochs none; a second Trainer reloads the views by fingerprint.
    ccfg = dict(cfg, TRAINING_4D_FEATURE_CACHE=True,
                TRAINING_4D_FEATURE_CACHE_DIR=os.path.join(workdir, "cache"),
                GLOBAL_OUTPUT_DIR=os.path.join(workdir, "runs4d_cache"))
    cmodel = NeuroEncoder(ccfg, device="cuda", seed=SEED)
    cached = Trainer(ccfg, cmodel, train_ds, val_ds)
    forwards = _encoder_forwards(cmodel)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cached._ensure_feature_cache()
    torch.cuda.synchronize()
    pre = {name: fn.launches for name, fn in counters.items()}
    log(phase, f"(b) precompute: {forwards[0]} encoder forwards in "
        f"{time.perf_counter() - t0:.1f} s host clock; launches {pre}")
    _check_counts("the 4D precompute", pre,
                  _want(BF16_BLOCK_KERNELS, depth * forwards[0], counters))
    add(pre)
    losses_b, epochs_b, _ = _run_trainer(cached, counters, epochs=2)
    _check_counts("the cached epochs", epochs_b, _want([], 0, counters))
    diffs = [abs(a - b) / max(abs(a), 1e-30)
             for a, b in zip(losses_b, losses_a)]
    log(phase, f"(b) cached epochs: losses {[round(v, 6) for v in losses_b]}"
        f", max relative difference from (a) {max(diffs):.3e} (tol "
        f"{CACHE_LOSS_RTOL}); no kernel launched")
    if len(losses_b) != len(losses_a) or max(diffs) > CACHE_LOSS_RTOL:
        raise AssertionError(f"cached losses {losses_b} against {losses_a}")
    view = cached._feature_cache["train"]
    worst, equal = 0.0, True
    for i in range(len(train_ds)):
        x = torch.from_numpy(train_ds.sample(i)["volume"][None]).cuda()
        fresh = cmodel.encode_sequence(x)[0].cpu()
        got = torch.from_numpy(view.feats[i])
        compare(f"cached features {i}", got, fresh)
        worst = max(worst, float((got - fresh).abs().max()))
        equal = equal and torch.equal(got, fresh)
    log(phase, f"(b) cached features against a fresh encode_sequence of "
        f"each sequence alone: max abs difference {worst:.3e}, bit-equal "
        f"{equal}")
    again = Trainer(ccfg, NeuroEncoder(ccfg, device="cuda", seed=SEED),
                    train_ds, val_ds)
    _, reload, text = _run_trainer(again, counters, epochs=1)
    if "loaded persisted train cache" not in text or \
            "loaded persisted val cache" not in text:
        raise AssertionError(f"the views were not reloaded: {text}")
    _check_counts("the reloaded cache's epoch", reload,
                  _want([], 0, counters))
    log(phase, "(b) a second Trainer reloaded both views by fingerprint "
        "and launched no kernel")
    del again, cached, cmodel

    # (c) The int8 encoder: K10-K13, never K1-K4; its checkpoint keeps
    # the f32 encoder and (a)'s keys.
    qcfg = dict(cfg, TRAINING_4D_ENCODER_QUANT="int8", TRAINING_EPOCHS=1,
                GLOBAL_OUTPUT_DIR=os.path.join(workdir, "runs4d_int8"))
    qmodel = NeuroEncoder(qcfg, device="cuda", seed=SEED)
    quant = Trainer(qcfg, qmodel, train_ds, val_ds)
    forwards = _count_forwards(quant._q8_encoder)
    losses_c, launches, _ = _run_trainer(quant, counters)
    _check_counts("the 4D int8 run", launches,
                  _want(INT8_KERNELS, depth * forwards[0], counters))
    add(launches)
    batch = next(iter(quant.val_dataloader))
    x = torch.from_numpy(batch["volume"]).cuda()
    f8 = qmodel.encode_sequence(x, encoder=quant._q8_encoder)
    fb = qmodel.encode_sequence(x)
    rel = float((f8 - fb).norm() / fb.norm())
    wa, wc = sd.load(ckpt_a), sd.load(_checkpoint(qcfg["GLOBAL_OUTPUT_DIR"]))
    same = set(wa) == set(wc) and all(
        torch.equal(wa[k], wc[k]) and wc[k].dtype == torch.float32
        for k in wa if k.startswith("volume_encoder."))
    log(phase, f"(c) int8 encoder: {forwards[0]} forwards, losses "
        f"{[round(v, 6) for v in losses_c]}; features against the bf16 "
        f"encoder's: relative error {rel:.3e} (tol {INT8_FEAT_RTOL}); "
        f"checkpoint keys and f32 encoder weights equal (a)'s: {same}; "
        f"launches {launches}")
    if rel > INT8_FEAT_RTOL or not same:
        raise AssertionError("the int8 encoder's features or checkpoint")

    # (d) Parity: 4D encodings against the 3D model's forward on the same
    # volumes; the head at f32 and one T = 4 sequence against the CPU.
    model3d = NeuroEncoder(dict(cfg, TRAINING_DIM=3), device="cuda",
                           seed=SEED + 1)
    model3d.load_state_dict(encoder0, strict=False)
    b, t = x.shape[0], x.shape[-1]
    with torch.no_grad():
        enc = model.encode_sequence(x)
        flat = model3d(x.permute(0, 4, 1, 2, 3).reshape(b * t, *x.shape[1:4]))
    diff = float((enc.reshape(b * t, -1) - flat).abs().max())
    log(phase, f"(d) 4D encodings of {b} x {t} volumes against the 3D "
        f"model's forward on them: max abs difference {diff:.3e} "
        f"(bit-equal {torch.equal(enc.reshape(b * t, -1), flat)})")
    if not torch.equal(enc.reshape(b * t, -1), flat):
        raise AssertionError("4D encodings differ from the 3D forward")
    del model3d, flat
    head = {k: v for k, v in model.state_dict().items()
            if not k.startswith("volume_encoder.")}
    fcfg = dict(cfg, TRAINING_PRECISION="f32")
    heads = {}
    for dev in ("cuda", "cpu"):
        m = NeuroEncoder(fcfg, device=dev, seed=SEED)
        m.load_state_dict(head, strict=False)
        with torch.no_grad():
            heads[dev] = m.apply_features(enc.to(dev)).cpu()
    diff = float((heads["cuda"] - heads["cpu"]).abs().max())
    log(phase, f"(d) temporal head + projection at f32 on those features: "
        f"cuda {heads['cuda'].tolist()} vs cpu, max diff {diff:.3e} (tol "
        f"{HEAD_F32_ATOL})")
    if diff > HEAD_F32_ATOL:
        raise AssertionError(f"the f32 head differs by {diff}")
    cpu = NeuroEncoder(cfg, device="cpu", seed=SEED + 2)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    _fold_against_cpu(model, cpu, x)
    x4 = torch.from_numpy(np.ascontiguousarray(
        val_ds.sample(0)["volume"][None, ..., :4]))
    t0 = time.perf_counter()
    with torch.no_grad():
        enc_want = cpu.encode_sequence(x4)
        want = cpu.apply_features(enc_want)
        got = model(x4.cuda()).cpu()
        enc_got = model.encode_sequence(x4.cuda()).cpu()
    diff = float((got - want).abs().max())
    enc_diff = float((enc_got - enc_want).abs().max())
    log(phase, f"(d) one sequence at T = 4, bf16: encodings cuda "
        f"{enc_got.tolist()} vs cpu {enc_want.tolist()}, max diff "
        f"{enc_diff:.3e}; logits cuda {got.tolist()} vs cpu {want.tolist()}, "
        f"max diff {diff:.3e} (tol {BF16_LOGIT_ATOL} for both); cpu "
        f"{time.perf_counter() - t0:.1f} s host clock")
    if diff > BF16_LOGIT_ATOL or enc_diff > BF16_LOGIT_ATOL:
        raise AssertionError(f"T = 4 encodings or logits differ by "
                             f"{enc_diff}, {diff}")
    del cpu

    # (e) Serving: Predictor, the batch CLI, HTTP, --quant int8.
    seqs = np.stack([val_ds.sample(i)["volume"] for i in range(2)])
    launches = fourd_serving(cfg, ckpt_a, seqs, workdir, counters)
    add(launches)

    # (f) Timing at config4D's shape, medians of CUDA-event timings.
    dbatch, _, _ = next(trainer._device_prefetch(trainer.val_dataloader))
    fbatch = {"volume": model.encode_sequence(dbatch["volume"]),
              "label": dbatch["label"], "valid": dbatch["valid"]}
    qbatch, _, _ = next(quant._device_prefetch(quant.val_dataloader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = {"step": cuda_ms(lambda: trainer.train_step(dbatch), 2, 7)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms["encoder"] = cuda_ms(lambda: model.encode_sequence(dbatch["volume"]),
                            2, 7)
    ms["cached step"] = cuda_ms(lambda: trainer.train_step(fbatch), 3, 25)
    ms["int8 step"] = cuda_ms(lambda: quant.train_step(qbatch), 2, 7)
    ms["int8 encoder"] = cuda_ms(lambda: qmodel.encode_sequence(
        qbatch["volume"], encoder=quant._q8_encoder), 2, 7)
    vols = b * t
    log(phase, f"(f) train step at B {b} x T {t} ({vols} volumes): "
        f"{ms['step']:.3f} ms ({vols / ms['step'] * 1e3:.1f} vol/s), the "
        f"encoder {ms['encoder']:.3f} ms = "
        f"{100 * ms['encoder'] / ms['step']:.1f} % of it; with the feature "
        f"cache {ms['cached step']:.3f} ms; with the int8 encoder "
        f"{ms['int8 step']:.3f} ms (its encoder {ms['int8 encoder']:.3f} ms "
        f"= {100 * ms['int8 encoder'] / ms['int8 step']:.1f} %); peak memory "
        f"{peak:.2f} GiB in the bf16 steps; {card}")
    profile_split(phase, "4D train step",
                  lambda: trainer.train_step(dbatch), ms["step"])
    profile_split(phase, "cached 4D train step",
                  lambda: trainer.train_step(fbatch), ms["cached step"])
    del trainer, quant, dbatch, qbatch, fbatch
    torch.cuda.empty_cache()

    # (g) The ResNet-18 volume encoder in 4D at B 1 x T 8, eval: K14 once
    # per forward, against the CPU plain path.
    rcfg = dict(cfg, MODEL_VOLUME_ENCODER="resnet")
    rmodel = NeuroEncoder(rcfg, device="cuda", seed=SEED)
    rcpu = NeuroEncoder(rcfg, device="cpu", seed=SEED)
    xr = np.ascontiguousarray(val_ds.sample(1)["volume"][None, ..., :8])
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        got = torch.softmax(rmodel(torch.from_numpy(xr).cuda()), -1).cpu()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _check_counts("the 4D ResNet forward", launches,
                  _want(RESNET_KERNELS[:1], 1, counters))
    add(launches)
    with torch.no_grad():
        enc_want = rcpu.encode_sequence(torch.from_numpy(xr))
        want = torch.softmax(rcpu.apply_features(enc_want), -1)
        enc_got = rmodel.encode_sequence(torch.from_numpy(xr).cuda()).cpu()
    diff = float((got - want).abs().max())
    enc_diff = float((torch.softmax(enc_got, -1)
                      - torch.softmax(enc_want, -1)).abs().max())
    log(phase, f"(g) ResNet-{rmodel.resnet_cfg.depth} encoder in 4D, B 1 x "
        f"T 8: the encoder's probabilities at the 8 timepoints against the "
        f"cpu's, max diff {enc_diff:.3e}; probs {got.tolist()} vs cpu "
        f"{want.tolist()}, max diff {diff:.3e} (tol {PROB_ATOL} for both); "
        f"launches {launches}")
    if diff > PROB_ATOL or enc_diff > PROB_ATOL:
        raise AssertionError(f"the 4D ResNet differs from the CPU by "
                             f"{enc_diff}, {diff}")
    log("counts", f"4d phase: launches {total}")
    if any(total[name] for name in BACKWARD_KERNELS):
        raise AssertionError(f"a 4D phase launched a backward kernel: {total}")
    return total


def fourd_serving(cfg, ckpt: str, seqs: np.ndarray, workdir: str,
                  counters: dict) -> dict:
    """(e): the 4D checkpoint through Predictor at n = 1 and 2 sequences,
    the batch CLI on two NIfTI series, one HTTP POST of a series with
    /healthz, and --quant int8. Returns the launch counts of the bf16
    Predictor's requests and the int8 ones."""
    import yaml

    from neurovit_tpu_torch import serving
    from neurovit_tpu_torch.data import nifti
    from neurovit_tpu_torch.serving import Predictor, _collect_volume_jobs
    from neurovit_tpu_torch.serving_http import make_server

    phase = "4d"
    depth = cfg["MODEL_VIT_DEPTH"]
    predictor = Predictor.from_checkpoint(cfg, ckpt, batch_size=2,
                                          device="cuda")
    forwards = _count_forwards(predictor.model.volume_encoder.vit3d)
    for fn in counters.values():
        fn.launches = 0
    _, probs = predictor(seqs)
    singles = np.concatenate([predictor(seqs[i:i + 1])[1] for i in range(2)])
    launches = {name: fn.launches for name, fn in counters.items()}
    _check_counts("4D serving", launches,
                  _want(BF16_BLOCK_KERNELS, depth * forwards[0], counters))
    log(phase, f"(e) Predictor, buckets {predictor.bucket_sizes}: 2 "
        f"sequences {probs.tolist()}, bit-equal to single calls "
        f"{np.array_equal(singles, probs)} (max diff "
        f"{float(np.abs(singles - probs).max()):.3e}); launches {launches}")
    if not np.isfinite(probs).all() or not np.array_equal(singles, probs):
        raise AssertionError("4D bucket parity")

    # The batch CLI on two series of CLI_T timepoints (raw 91 x 109 x 91).
    rng = np.random.default_rng(SEED + 9)
    paths = []
    for i in range(2):
        path = os.path.join(workdir, f"series{i}.nii")
        nifti.save(path, rng.standard_normal((91, 109, 91, CLI_T)).astype(
            np.float32))
        paths.append(path)
    cfg_path = os.path.join(workdir, "config4d.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(workdir, "pred4d.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        serving.main(paths + ["--config", cfg_path, "--checkpoint", ckpt,
                              "--output", out])
    with open(out) as f:
        rows = f.read().strip().splitlines()
    series = np.stack([v for _, _, v in _collect_volume_jobs(
        paths, True, sequence=True)])
    _, want = predictor(series)
    got = np.array([[float(p) for p in r.split(",")[3:]] for r in rows[1:]])
    if ([r.split(",")[:2] for r in rows[1:]] != [[p, "-1"] for p in paths]
            or got.shape != want.shape
            or np.abs(got - want).max() > PROB_ATOL):
        raise AssertionError(f"the 4D CLI wrote {rows}")
    log(phase, f"(e) batch CLI on two series of T {CLI_T}: rows "
        f"{[r.split(',')[1:3] for r in rows[1:]]}, max diff vs Predictor "
        f"{float(np.abs(got - want).max()):.3e}")

    # HTTP: /healthz and one POST of a series.
    server, batcher = make_server(predictor, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        with open(paths[0], "rb") as f:
            req = urllib.request.Request(url + "/predict", data=f.read(),
                                         method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, rows = resp.status, json.loads(resp.read())["rows"]
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=60)
        server.server_close()
    diff = float(np.abs(np.array(rows[0]["probs"]) - want[0]).max())
    log(phase, f"(e) /healthz {health}; POST series0: {status}, rows "
        f"{rows}, max diff vs Predictor {diff:.3e}")
    if (health.get("is_4d") is not True or status != 200 or len(rows) != 1
            or rows[0]["timepoint"] != -1 or diff > PROB_ATOL):
        raise AssertionError("4D HTTP serving")
    del predictor

    # --quant int8 on the same checkpoint: K10-K13 only.
    q8 = Predictor.from_checkpoint(cfg, ckpt, batch_size=2, device="cuda",
                                   quant="int8")
    forwards = _count_forwards(q8.model.volume_encoder.vit3d)
    for fn in counters.values():
        fn.launches = 0
    _, got = q8(seqs)
    int8 = {name: fn.launches for name, fn in counters.items()}
    _check_counts("4D int8 serving", int8,
                  _want(INT8_KERNELS, depth * forwards[0], counters))
    diff = float(np.abs(got - probs).max())
    log(phase, f"(e) --quant int8: {got.tolist()}, max diff vs bf16 "
        f"{diff:.3e} (tol {INT8_ATOL}); launches {int8}")
    if diff > INT8_ATOL:
        raise AssertionError(f"4D int8 serving differs by {diff}")
    return {name: launches[name] + int8[name] for name in counters}


# ---------------------------------------------------------------------------
# train_features: remat, profile steps, async checkpoints and the sweep
# ---------------------------------------------------------------------------

# The CUDA kernels (the sources' __global__ functions) that each block
# kernel's wrapper launches in a train step at dropout 0.1; the profiled
# window's trace must name every one. K3 is one launch of K4's
# fc2_residual pass, so its name is K4's.
TRACE_NAMES = {
    "flash_attention": ["flash_fwd_kernel"],
    "fused_ln_qkv": ["ln_rows_kernel", "qkv_gemm_kernel"],
    "fused_outproj_residual": ["fc2_residual_kernel"],
    "fused_mlp_block": ["ln_rows_kernel", "fc1_gelu_kernel",
                        "fc2_residual_kernel"],
    "flash_attention_bwd": ["flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"],
    "fused_ln_qkv_bwd": ["row_stats_kernel", "du_kernel", "ln_bwd_kernel",
                         "colsum_kernel"],
    "fused_outproj_bwd": ["dz_rows_kernel", "dattn_kernel"],
    "fused_mlp_bwd": ["dz_rows_kernel", "hidden_kernel", "du_kernel",
                      "ln_bwd_kernel", "colsum_kernel"],
}
# The sweep's card memory after its second trial against after its first.
SWEEP_MEMORY_RTOL = 0.05


def _reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def _read(counters: dict, total: dict) -> dict:
    """The counts since the last _reset, also added into ``total``."""
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        total[name] += n
    return launches


def _step_launches(counters: dict, forwards: int, backwards: int) -> dict:
    """A ViT train run's counts: K1-K4 ``forwards`` times, K5 and K7-K9
    ``backwards`` times, nothing else."""
    return {name: forwards if name in BF16_BLOCK_KERNELS
            else backwards if name in BACKWARD_KERNELS else 0
            for name in counters}


def _grad_step(trainer, batch, zyx) -> tuple:
    """One Trainer.train_step; returns its loss and every parameter's
    gradient as the optimizer got them, both copied to the host."""
    grads = {}
    opt_step = trainer.optimizer.step

    def capture():
        for name, p in trainer.model.named_parameters():
            grads[name] = p.grad.detach().cpu()
        return opt_step()

    trainer.optimizer.step = capture
    try:
        loss = trainer.train_step(batch, zyx)["loss"].detach().cpu()
    finally:
        del trainer.optimizer.step       # the class's method again
    return loss, grads


def _timed_steps(trainer, batch, zyx, warmup: int = 3, runs: int = 5
                 ) -> tuple:
    """Median step ms of ``runs`` after ``warmup`` steps, all the times,
    and the peak memory of those steps in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, zyx)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)), [round(t, 2) for t in times],
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _equal_states(a, b, where: str = "") -> None:
    """Two loaded checkpoints hold equal values, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b)):
            raise AssertionError(f"{where} differs")
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            _equal_states(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_states(x, y, f"{where}/{i}")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def _remat_part(config, workdir: str, card: str, counters: dict,
                total: dict) -> None:
    """(a) The flagship at batch 128, dropout 0.1, one seed: a train step
    without remat, again without, and with remat. The remat step's loss
    and gradients equal the first step's wherever the two steps without
    remat are bit-equal, else within their largest gap; step ms and peak
    memory with and without remat; K1-K4 depth - 1 more launches a step."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer

    phase = "train_features"
    batch_size = 128
    base = _train_config(config, workdir, TRAINING_BATCH_SIZE=batch_size)
    size = base["TRAINING_VIT_INPUT_SIZE"]
    ds = _SeededVolumes(batch_size, size, SEED + 4, "remat")
    runs, timing, batch = {}, {}, None
    for name, remat in (("plain", False), ("again", False), ("remat", True)):
        gc.collect()        # no earlier trainer's tensors in the peak
        cfg = dict(base, TRAINING_REMAT=remat)
        model = NeuroEncoder(cfg, device="cuda", seed=SEED)
        depth = model.vit_cfg.depth
        trainer = Trainer(cfg, model, ds, ds)
        if batch is None:
            batch, zyx, _ = next(trainer._device_prefetch(
                trainer.val_dataloader))
        _reset(counters)
        runs[name] = _grad_step(trainer, batch, zyx)
        torch.cuda.synchronize()
        _check_counts(f"{phase} (a) {name} step", _read(counters, total),
                      _step_launches(counters, (2 * depth - 1) if remat
                                     else depth, depth))
        if name != "again":
            _reset(counters)
            timing[name] = _timed_steps(trainer, batch, zyx)
            _check_counts(f"{phase} (a) {name} timed steps",
                          _read(counters, total),
                          _step_launches(counters, 8 * ((2 * depth - 1)
                                                        if remat else depth),
                                         8 * depth))
        del trainer, model
    (loss0, g0), (loss1, g1), (loss_r, g_r) = (runs["plain"], runs["again"],
                                               runs["remat"])
    gaps = {k: _max_gap(g0[k], g1[k]) for k in g0}
    worst = max(gaps.values())
    bit_equal = [k for k, gap in gaps.items() if gap == 0]
    if g_r.keys() != g0.keys():
        raise AssertionError("remat changed the set of gradients")
    for k in g0:
        gap = _max_gap(g_r[k], g0[k])
        if (gaps[k] == 0 and not torch.equal(g_r[k], g0[k])) or gap > worst:
            raise AssertionError(
                f"remat gradient {k} is {gap} from the step without remat "
                f"(two steps without remat: {gaps[k]}, largest {worst})")
    if abs(float(loss_r) - float(loss0)) > abs(float(loss1) - float(loss0)):
        raise AssertionError(f"remat loss {loss_r} against {loss0}, {loss1}")
    log(phase, f"(a) remat at batch {batch_size}, dropout {DROPOUT}: loss "
        f"{float(loss_r):.6f} (without remat {float(loss0):.6f}, "
        f"{float(loss1):.6f}); {len(bit_equal)} of {len(g0)} gradients "
        f"bit-equal between the two steps without remat, the remat step's "
        f"equal to them there and within the largest gap ({worst:.3e}) "
        f"elsewhere")
    for name in ("plain", "remat"):
        ms, times, peak = timing[name]
        log(phase, f"(a) {name}: step {ms:.2f} ms median of 5 (all "
            f"{times}), {batch_size / ms * 1e3:.1f} vol/s, peak memory "
            f"{peak:.2f} GiB; {card}")
    log(phase, f"(a) remat costs {timing['remat'][0] / timing['plain'][0]:.3f}"
        f"x the step and saves "
        f"{timing['plain'][2] - timing['remat'][2]:.2f} GiB of peak memory")


def _trace_kernel_names(prof_dir: str) -> set:
    """The CUDA kernel names in the one Chrome trace under ``prof_dir``."""
    import glob
    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {prof_dir}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events
            if str(e.get("cat", "")).lower() == "kernel"}


def _profile_part(config, workdir: str, counters: dict, total: dict
                  ) -> None:
    """(b) Trainer.run() of 6 steps at batch 8 with TRAINING_PROFILE_STEPS
    2: the trace under GLOBAL_OUTPUT_DIR/profile names the CUDA kernels of
    K1-K5 and K7-K9 (names, not counts: the profiler's traces lose kernel
    records, PERF.md §7)."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer

    phase = "train_features"
    cfg = _train_config(config, workdir, TRAINING_BATCH_SIZE=8,
                        TRAINING_PROFILE_STEPS=2,
                        GLOBAL_OUTPUT_DIR=os.path.join(workdir, "prof_runs"))
    size = cfg["TRAINING_VIT_INPUT_SIZE"]
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    depth = model.vit_cfg.depth
    trainer = Trainer(cfg, model, _SeededVolumes(48, size, SEED + 5, "prof"),
                      _SeededVolumes(8, size, SEED + 6, "prof_val"))
    t0 = time.perf_counter()
    _, launches, text = _run_trainer(trainer, counters)
    secs = time.perf_counter() - t0
    _read(counters, total)
    _check_counts(f"{phase} (b)", launches,
                  _step_launches(counters, 7 * depth, 6 * depth))
    if "MODEL SAVED to ." not in text:
        raise AssertionError("the profiled run saved no checkpoint")
    names = _trace_kernel_names(os.path.join(cfg["GLOBAL_OUTPUT_DIR"],
                                             "profile"))
    for kernel, parts in TRACE_NAMES.items():
        missing = [p for p in parts if not any(p in n for n in names)]
        if missing:
            raise AssertionError(f"the profiled window's trace names no "
                                 f"{missing} of {kernel}")
    log(phase, f"(b) TRAINING_PROFILE_STEPS 2: Trainer.run() of 6 steps in "
        f"{secs:.1f} s host clock; the trace of steps 2-4 names "
        f"{len(names)} CUDA kernels, among them every pass of K1-K5 and "
        f"K7-K9 ({sorted(set(p for v in TRACE_NAMES.values() for p in v))})")
    del trainer, model


def _async_part(config, workdir: str, counters: dict, total: dict) -> None:
    """(c) Two epochs twice on the same seeds, with
    TRAINING_ASYNC_CHECKPOINT and without: every tensor of both epochs'
    model-e{N} train states and weight files equal between the runs; each
    run's epoch times."""
    import glob
    import shutil

    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training import Trainer
    from neurovit_tpu_torch.training import checkpoint as ckpt

    phase = "train_features"
    files, epoch_s = {}, {}
    for mode in (False, True):
        cfg = _train_config(config, workdir, TRAINING_BATCH_SIZE=8,
                            TRAINING_EPOCHS=2,
                            TRAINING_ASYNC_CHECKPOINT=mode,
                            GLOBAL_OUTPUT_DIR=os.path.join(
                                workdir, f"async_{mode}"))
        size = cfg["TRAINING_VIT_INPUT_SIZE"]
        model = NeuroEncoder(cfg, device="cuda", seed=SEED)
        depth = model.vit_cfg.depth
        trainer = Trainer(cfg, model,
                          _SeededVolumes(16, size, SEED + 7, "async"),
                          _SeededVolumes(8, size, SEED + 8, "async_val"))
        starts = []
        train = trainer.train

        def timed_train(epoch, train=train, starts=starts):
            starts.append(time.perf_counter())
            return train(epoch)

        trainer.train = timed_train
        _, launches, _ = _run_trainer(trainer, counters)
        starts.append(time.perf_counter())
        del trainer.train
        _read(counters, total)
        _check_counts(f"{phase} (c)", launches,
                      _step_launches(counters, 6 * depth, 4 * depth))
        if ckpt._in_flight is not None:
            raise AssertionError("Trainer.run() left a save in flight")
        epoch_s[mode] = np.diff(starts).tolist()
        files[mode] = sorted(glob.glob(os.path.join(
            cfg["GLOBAL_OUTPUT_DIR"], "*", "model-e*")))
        del trainer, model
    names = [os.path.basename(f) for f in files[False]]
    if names != ["model-e0", "model-e0.state_dict.pkl", "model-e1",
                 "model-e1.state_dict.pkl"] or names != [
                     os.path.basename(f) for f in files[True]]:
        raise AssertionError(f"checkpoints {files}")
    for sync, async_ in zip(files[False], files[True]):
        if sync.endswith(".pkl"):
            a, b = (torch.load(f, weights_only=True) for f in (sync, async_))
        else:
            a, b = (ckpt.load_train_state(f) for f in (sync, async_))
        _equal_states(a, b, os.path.basename(sync))
    log(phase, f"(c) two epochs of 2 steps at batch 8 with and without "
        f"TRAINING_ASYNC_CHECKPOINT: {names} equal tensor for tensor; "
        f"epoch seconds (train, validate, save) sync "
        f"{[round(t, 3) for t in epoch_s[False]]}, async "
        f"{[round(t, 3) for t in epoch_s[True]]}")
    for mode in (False, True):
        shutil.rmtree(os.path.join(workdir, f"async_{mode}"))


def _sweep_part(config, workdir: str, counters: dict, total: dict) -> None:
    """(d) ``main(["--sweep", ...])`` in this process on the card: two
    trials at full width and depth 2 of a synthetic gradcam set, under a
    GLOBAL_BASE_PATH holding configs/sweep.yaml with epochs cut to [1].
    Two trials with finite val_loss, their parameters those run_sweep
    proposes on the CPU at the seed, and card memory after trial 2 within
    SWEEP_MEMORY_RTOL of after trial 1."""
    import yaml

    from neurovit_tpu_torch import main as port_main
    from neurovit_tpu_torch.training.sweep import run_sweep

    phase = "train_features"
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "sweep.yaml")) as f:
        sweep_cfg = yaml.safe_load(f)
    sweep_cfg["parameters"]["epochs"] = {"values": [1]}
    base = os.path.join(workdir, "sweep_base")
    os.makedirs(os.path.join(base, "configs"))
    sweep_path = os.path.join(base, "configs", "sweep.yaml")
    with open(sweep_path, "w") as f:
        yaml.safe_dump(sweep_cfg, f)
    cfg = {**config, "MODEL_VIT_DEPTH": 2, "DATASET_NAME": "gradcam",
           "DATASET_GENERATE": False, "GRADCAM_NUM_SAMPLES": 80,
           "GRADCAM_TRAIN_PATH": None, "GRADCAM_VAL_PATH": None,
           "GLOBAL_BASE_PATH": base, "SWEEP_COUNT": 2,
           "GLOBAL_OUTPUT_DIR": os.path.join(workdir, "sweep_runs")}
    cfg_path = os.path.join(workdir, "sweep_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    trial, after, trial_s = port_main.sweep_trial, [], []

    def recorded(trial_config, device):
        t0 = time.perf_counter()
        metrics = trial(trial_config, device)
        torch.cuda.synchronize()
        trial_s.append(time.perf_counter() - t0)
        after.append(torch.cuda.memory_allocated())
        return metrics

    before = torch.cuda.memory_allocated()
    out = io.StringIO()
    port_main.sweep_trial = recorded
    _reset(counters)
    try:
        with contextlib.redirect_stdout(out):
            port_main.main(["--sweep", "--wandb", "false", "--config",
                            cfg_path])
    finally:
        port_main.sweep_trial = trial
    torch.cuda.synchronize()
    launches = _read(counters, total)
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("[sweep]", "Sweep", "[VALIDATION]")):
            log(phase, "(d) " + line.expandtabs(1))
    with open(os.path.join(cfg["GLOBAL_OUTPUT_DIR"],
                           "sweep_results.jsonl")) as f:
        trials = [json.loads(line) for line in f]
    if [t["trial"] for t in trials] != [0, 1] or not all(
            np.isfinite(t["metrics"]["val_loss"]) for t in trials):
        raise AssertionError(f"sweep results {trials}")
    cpu_dir = os.path.join(workdir, "sweep_cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        run_sweep(dict(cfg, GLOBAL_OUTPUT_DIR=cpu_dir),
                  lambda _config: {"val_loss": 0.0}, sweep_path, count=2)
    with open(os.path.join(cpu_dir, "sweep_results.jsonl")) as f:
        want = [json.loads(line)["params"] for line in f]
    if [t["params"] for t in trials] != want:
        raise AssertionError(f"the card's sweep proposed "
                             f"{[t['params'] for t in trials]}, the CPU's "
                             f"run_sweep {want}")
    for name in BF16_BLOCK_KERNELS + BACKWARD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"the sweep launched no {name}")
    mib = [a / 2 ** 20 for a in after]
    log(phase, f"(d) --sweep: 2 trials in {[round(t, 1) for t in trial_s]} "
        f"s, val_loss {[t['metrics']['val_loss'] for t in trials]}, params "
        f"equal to the CPU run_sweep's; card memory allocated before "
        f"{before / 2 ** 20:.1f} MiB, after each trial "
        f"{[round(m, 1) for m in mib]} MiB; launches {launches}")
    if abs(after[1] - after[0]) > SWEEP_MEMORY_RTOL * after[0]:
        raise AssertionError(f"card memory grew from trial 1 to trial 2: "
                             f"{mib} MiB")


def train_features_phase(config, workdir: str, card: str,
                         counters: dict) -> dict:
    """Remat, profile steps, async checkpoints and the sweep at the flagship
    width ((a)-(d) above); returns the phase's launch counts."""
    t0 = time.perf_counter()
    total = {name: 0 for name in counters}
    _remat_part(config, workdir, card, counters, total)
    torch.cuda.empty_cache()
    _profile_part(config, workdir, counters, total)
    _async_part(config, workdir, counters, total)
    torch.cuda.empty_cache()
    _sweep_part(config, workdir, counters, total)
    log("train_features", f"done in {time.perf_counter() - t0:.1f} s; "
        f"launches {total}")
    return total


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches, by
    the kernel's name."""
    from neurovit_tpu_torch.ops import (dropout, flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv, int8_gemm,
                                        int8_serving, maxpool3d)
    return {
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
        "max_pool3d_argmax": maxpool3d.max_pool3d_argmax_cuda,
        "max_pool3d_argmax_bwd": maxpool3d.max_pool3d_argmax_bwd_cuda,
        "dropout": dropout.dropout_cuda,
        "gemm_bf16": int8_gemm.gemm_bf16_cuda,
        "gemm_int8": int8_gemm.gemm_int8_cuda,
        "dynquant_matmul": int8_gemm.dynquant_matmul_cuda,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on the card only", file=sys.stderr)
        return 1
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.ops import _build
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.models import NeuroEncoder

    # The plain versions' f32 matmuls are the reference: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
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
    build_notes(lib)

    kernel_stats = kernel_phase(card)
    torch.cuda.empty_cache()

    counters = kernel_counters()
    widths_phase(card)
    torch.cuda.empty_cache()
    probe_stats, probe_launches = probes_phase(card, counters)
    kernel_stats.update(probe_stats)
    torch.cuda.empty_cache()
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
            name: 0 if name.endswith("_bwd")
            or name in OFF_BLOCK_KERNELS
            else depth * forwards[0] for name in counters})
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
        torch.cuda.empty_cache()
        feature_launches = train_features_phase(config, workdir, card,
                                                counters)
        torch.cuda.empty_cache()
        resnet_launches = resnet_phase(config, workdir, card, counters)
        torch.cuda.empty_cache()
        fourd_launches = fourd_phase(workdir, card, counters)
        torch.cuda.empty_cache()
        widths_model_phase(config, workdir, counters)

    launches.update({name: int8_launches[name] for name in INT8_KERNELS})
    launches.update(probe_launches)
    launches.update({name: gradcam_launches[name]
                     for name in GRADCAM_KERNELS})
    launches.update({name: resnet_launches[name] for name in RESNET_KERNELS})
    for name, n in fourd_launches.items():
        launches[name] += n
    for name, n in feature_launches.items():
        launches[name] += n
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **{key: kernel_stats[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "device_ms", "library_device_ms")
            if key in kernel_stats[name]}}
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
