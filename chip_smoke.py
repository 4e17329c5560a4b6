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
18. f32        K1-K5, K7-K9 at f32 (every product in 3xTF32 on the
               tensor cores: K1, K5, K6 and its backward on mma.sync, the
               other GEMMs on wgmma; the row passes on the CUDA cores),
               with
               torch.backends.cuda.matmul.allow_tf32 off: (a) each against
               its plain version at the flagship block (batch 8 x 1001),
               within 1e-4 (1 + |plain|), two calls bit-equal: K1 at
               n_valid 1001 and 900, at dropout 0.1 with its row sums, and
               at head dims 32, 64 and 128 at batch 2 x 2 heads; K2
               serving and with u, at 130 rows and on all-zero rows with
               beta = 0 (u = 0 there); K3 at dropout 0 and 0.1, at 130
               rows, on all-zero rows of a (y = x + b there) and at the
               2D tutorial's widths (dim 64, inner 64); K4 serving, at dropout 0.1 with h, at 130 rows and
               on all-zero rows with beta = b1 = 0 (h = 0, y = b2 there);
               the first case of each timed by CUDA events beside the
               plain version, its library yardstick (f32 SDPA; torch.mm at
               f32 for each GEMM pass), its bound (bytes at 3.35 TB/s or
               operations at 165 TFLOP/s, 3xTF32) and its FFMA floor
               (67 TFLOP/s); K1's o in each case within 1e-5 relative
               Frobenius error of plain, and K1 at the flagship block
               timed in turns with f32 SDPA, its rate, its share of the
               bound and of mma.sync's 3xTF32 ceiling (107 TFLOP/s) and
               the factor between the two; K4's y, K2's q and K3's y - x
               (3xTF32 on wgmma) within 1e-5 relative Frobenius error of
               plain in each case, each timed in turns beside f32
               torch.mm at its GEMMs with its rate and share of the
               bound; their weight pre-pass bit-equal to plain on W1, W2,
               Wqkv, Wout, the 2D tutorial's Wqkv and a ragged weight, a
               launch for each weight of every K2, K3 and K4 f32 call; (b) the seed-42 flagship
               served at f32 by Predictor (every bucket, 3 volumes) and
               one HTTP POST, each
               f32 kernel launched depth times per forward and no other
               kernel; the logits of 3 volumes against the CPU plain path
               within 1e-3; the forward at batch 32 timed with a profiler
               split; (c) config4D at f32 (B 2 x T 140): Trainer.run() of
               one epoch, two steps with finite losses, K1-K4 at f32 depth
               times per encoder forward and nothing else; the step and
               the encoder timed, peak memory; the encodings and the last
               block's output of the first and last timepoint of each
               sequence against the CPU plain path within 1e-3; (d) K5,
               K7, K8 and K9 at f32 against their plain versions at the
               flagship block, the data gradients within 1e-4 (1 +
               |plain|), dgamma and dbeta within 1e-5 relative Frobenius
               error, two calls bit-equal: K5 at n_valid 1001 (dropout
               0.1 and 0) and 900 and at head dims 32, 64 and 128; K7, K8
               and K9 at dropout 0.1 and 0, at 130 rows and on all-zero
               rows of dqkv or dy (dx, dattn, dz and dh 0 there); each
               timed as in (a), beside f32 torch.mm at its GEMMs or f32
               SDPA's backward; K8's dattn (3xTF32 on wgmma) within 1e-5
               relative Frobenius error of plain in each case, and at
               dropout 0 timed in turns beside f32 torch.mm(dy, Wout); its
               weight pre-pass bit-equal to plain on Wout, 64 x 64 and
               48 x 80, a launch at every K8 f32 call; (e) the
               flagship's loss and every parameter gradient at f32 (batch
               2, dropout 0.1) on cuda
               against the CPU plain path, the worst within 1e-3 relative
               Frobenius error; (f) Trainer.run() of the flagship at f32
               (two steps at batch 32 and a validation batch), K1-K4 at
               f32 depth times per forward and K5, K7-K9 at f32 depth
               times per step, nothing else; the step at batch 32 timed
               (vol/s, TFLOP/s at 274.4 GFLOP a volume, peak memory) with
               a profiler split; the smoke model trained at f32 through
               the CLI, launching the f32 kernels only; (g) K10-K13 at f32
               against their plain versions at the flagship block within
               1e-2 + 2^-6 |plain| on the rows whose codes are plain's,
               the codes in the kernels' scratch (K10's and K12's u8,
               K11's a8, K12's g8) one step off plain's at most and in at
               most 1e-3 of the positions, the outputs plain's arithmetic
               on the kernels' own codes bit for bit (K11 plain's bit for
               bit), two calls bit-equal: K10 and K12 serving, at 130
               rows and on all-zero rows, K11 also on all-zero rows of a,
               K13 at n_valid 1001 and 900 and at head dims 32, 64 and
               128; each timed beside plain and torch._int_mm at its
               GEMMs (K13 beside K1 at f32 and its FFMA floor); (h) the
               seed-42 flagship at f32 served with quant="int8" by
               Predictor, one POST and the batch CLI, each f32 int8
               kernel launched depth times per forward and no other, a
               SERVING_INT8_ATTN off forward (K1 at f32 in place of
               K13), the probabilities within 1e-3 of the CPU's f32 int8
               path (the logits within 1e-2) and within 0.05 of f32
               serving, the forward at batch 32 with a profiler split;
               (i) config4D at f32 with the int8 encoder through
               Trainer.run(), uncached and with the feature cache, the
               f32 int8 kernels depth times per encoder forward, the
               step and the encoder timed, the fold against the CPU;
               (j) K6 and its backward at f32 against their plain
               versions within 1e-4 (1 + |plain|), two calls bit-equal:
               the flagship probe's block in [B, H, N, D] (8 x 8 x 1001 x
               64) at dropout 0 and 0.1 and at n_valid 900, head dims 16,
               32, 64 and 128 at batch 2 x 2 heads; the first case timed
               beside plain, f32 SDPA or its backward and the bound, and
               bit-equal to K1 or K5 at f32 on the same heads in
               [B, N, H, D]; K6's o in each case within 1e-5 relative
               Frobenius error of plain and the flagship probe's block
               timed in turns with f32 SDPA as K1's; (k) the seed-42
               flagship at f32 with its
               LayerNorm affines lifted: get_attention_map, the menu's
               gradcam and ablationcam (score_batch 16), integrated
               gradients (4 steps) and grad x input, each call's launches
               exact (one K6 f32 forward and backward per probe, no bf16
               kernel), the probe's logits, activations, gradients and raw
               CAM, the menu's raw gradcam, one AblationCAM chunk's
               scores, the attributions against the CPU plain path within
               1e-5 relative Frobenius error, as is the CPU one ulp off
               against itself; Grad-CAM timed at batch 1 and 8; (l) the
               2D CAM tutorial (vit_cam_2d): the demo ViT trained for 300
               steps, layercam and scorecam on 8 held-out squares (at
               least 7 classified right, at least 5 maps brighter on the
               square for each), its logits against the CPU, the CLI's
               main() with --steps 200 writing its PNG; every f32 kernel
               and K6 f32 forward and backward launched
19. widths     the verify recipe's smoke model (dim 64, 4 heads of 16)
               trained for an epoch in bf16 on cuda through the CLI's main(),
               every block kernel launched; a ViT-B-width model (768, 12 x
               64, 3072, depth 4) served by Predictor against the CPU plain
               path
20. dp         data parallelism (neurovit_tpu_torch/parallel): (a) the CLI
               under torchrun at world 1, NCCL, 3 steps of the flagship in
               bf16 on seeded synthetic cubes, its train and validation
               lines and its train state bit-equal to the CLI's run with
               no process group; the step at batch 128 through the NCCL
               path beside the plain step
               (scripts/torch_dp_step_times.py, in turns); (b) two ranks on
               the one card over gloo (a file:// rendezvous the port
               adopts) against one process on the same global batch: the
               flagship bf16 at 16, f32 at 8, the ResNet-18 at 4 (f32)
               through the global BatchNorm, config4D's B 2 x T 140 on the
               int8 encoder with the stream split 140 / 140, at dropout 0:
               losses within DP_LOSS_RTOL, reduced gradients within the
               bf16 or f32 gradient bound, parameters, gradients and
               running statistics bit-equal on the ranks, each rank's
               launches the one-process step's; (c) the flagship served at
               batch 32 on two replicas on cuda:0, bf16 and int8, against
               one replica; the phase's seconds
21. tp         tensor parallelism (parallel/tensor_parallel.py): (a) the
               flagship served by one replica tensor-parallel over
               [cuda:0, cuda:0] (MESH_MODEL_AXIS 2) at bf16, f32 and int8
               of both against the one-replica Predictor: labels equal,
               the bounds of _tp_serving, every block's forms launched on
               both shards and no whole-width pass; (b) two ranks at tp 2
               on the one card over gloo against one process: the
               flagship bf16 and f32 at batch 8, config4D's B 2 x T 140 on
               the int8 encoder: losses, gathered gradients, the f32
               update at JAX's bounds, bit-equal ranks, each case's forms
               launched and no whole-width pass; (c) each
               tensor-parallel form (ops/tp_forms.py) against its plain
               version at the tp 2 shard widths, the shards' f32 partials
               summed against the whole-width kernel, the split int8
               row-quantize's codes bit-equal to K11's and K12's, timed by
               events and device time beside the whole-width pass; two
               ranks share one card, so no speed-up is claimed

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
    ("flash_attention_f32", "neurovit_tpu_torch/csrc/flash_attention_f32.cu",
     "neurovit_tpu/ops/flash_attention.py:233"),
    ("fused_ln_qkv_f32", "neurovit_tpu_torch/csrc/fused_qkv_f32.cu",
     "neurovit_tpu/ops/fused_qkv.py:57"),
    ("fused_outproj_residual_f32",
     "neurovit_tpu_torch/csrc/fused_outproj_f32.cu",
     "neurovit_tpu/ops/fused_outproj.py:44"),
    ("fused_mlp_block_f32", "neurovit_tpu_torch/csrc/fused_mlp_f32.cu",
     "neurovit_tpu/ops/fused_mlp.py:108"),
    # The forwards' weight pre-pass (W1, W2, Wqkv and Wout split for 3xTF32
    # as they lie), a launch of its own wrapper for each weight of every K4
    # f32, K2 f32 and K3 f32 call.
    ("fused_fwd_wsplit_f32", "neurovit_tpu_torch/csrc/tf32x3_wgmma.cuh",
     "neurovit_tpu/ops/fused_mlp.py:108"),
    ("flash_attention_bwd_f32",
     "neurovit_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "neurovit_tpu/ops/flash_attention.py:269"),
    ("fused_ln_qkv_bwd_f32", "neurovit_tpu_torch/csrc/fused_qkv_bwd_f32.cu",
     "neurovit_tpu/ops/fused_qkv.py:71"),
    ("fused_outproj_bwd_f32",
     "neurovit_tpu_torch/csrc/fused_outproj_bwd_f32.cu",
     "neurovit_tpu/ops/fused_outproj.py:56"),
    # The f32 backwards' weight pre-pass (the weight's transpose split for
    # 3xTF32), a launch of its own wrapper for each weight of every K8 f32
    # (Wout), K9 f32 (W2, W1) and K7 f32 (Wqkv) call.
    ("fused_outproj_bwd_wsplit_f32",
     "neurovit_tpu_torch/csrc/tf32x3_wgmma.cuh",
     "neurovit_tpu/ops/fused_outproj.py:56"),
    ("fused_mlp_bwd_f32", "neurovit_tpu_torch/csrc/fused_mlp_bwd_f32.cu",
     "neurovit_tpu/ops/fused_mlp.py:141"),
    ("int8_ln_qkv_f32", "neurovit_tpu_torch/csrc/int8_qkv.cu",
     "neurovit_tpu/ops/int8_serving.py:154"),
    ("int8_outproj_residual_f32", "neurovit_tpu_torch/csrc/int8_outproj.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_mlp_block_f32", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:173"),
    ("int8_flash_attention_f32",
     "neurovit_tpu_torch/csrc/int8_attention_f32.cu",
     "neurovit_tpu/ops/int8_serving.py:286"),
    ("flash_attention_bhnd_f32",
     "neurovit_tpu_torch/csrc/flash_attention_f32.cu",
     "neurovit_tpu/ops/flash_attention.py:91"),
    ("flash_attention_bhnd_bwd_f32",
     "neurovit_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "neurovit_tpu/ops/flash_attention.py:152"),
    # The tensor-parallel forms (ops/tp_forms.py): a shard's f32 partial of
    # a row-parallel product (K3's and K4's fc2 pass), of a LayerNorm
    # backward behind a column-parallel one (K7, K9), and the int8 row
    # quantize split around the model group's max with the int32
    # accumulator and the epilogue on the group's sum (K11, K12).
    ("fused_outproj_partial", "neurovit_tpu_torch/csrc/fused_outproj.cu",
     "neurovit_tpu/ops/fused_outproj.py:44"),
    ("fused_outproj_partial_f32",
     "neurovit_tpu_torch/csrc/fused_outproj_f32.cu",
     "neurovit_tpu/ops/fused_outproj.py:44"),
    ("fused_mlp_partial", "neurovit_tpu_torch/csrc/fused_mlp.cu",
     "neurovit_tpu/ops/fused_mlp.py:108"),
    ("fused_mlp_partial_f32", "neurovit_tpu_torch/csrc/fused_mlp_f32.cu",
     "neurovit_tpu/ops/fused_mlp.py:108"),
    ("fused_ln_qkv_bwd_partial", "neurovit_tpu_torch/csrc/fused_qkv_bwd.cu",
     "neurovit_tpu/ops/fused_qkv.py:71"),
    ("fused_mlp_bwd_partial", "neurovit_tpu_torch/csrc/fused_mlp_bwd.cu",
     "neurovit_tpu/ops/fused_mlp.py:141"),
    ("fused_mlp_bwd_partial_f32",
     "neurovit_tpu_torch/csrc/fused_mlp_bwd_f32.cu",
     "neurovit_tpu/ops/fused_mlp.py:141"),
    ("int8_row_amax", "neurovit_tpu_torch/csrc/int8_rowquant.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_row_amax_f32", "neurovit_tpu_torch/csrc/int8_rowquant.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_outproj_partial", "neurovit_tpu_torch/csrc/int8_outproj.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_outproj_partial_f32", "neurovit_tpu_torch/csrc/int8_outproj.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_mlp_hidden", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:173"),
    ("int8_mlp_hidden_f32", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:173"),
    ("int8_mlp_partial", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:173"),
    ("int8_dequant_residual", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
    ("int8_dequant_residual_f32", "neurovit_tpu_torch/csrc/int8_mlp.cu",
     "neurovit_tpu/ops/int8_serving.py:167"),
]
# The tensor-parallel forms: only the tp phase's shards launch them.
TP_KERNELS = [name for name, _, _ in KERNELS[-16:]]
# K10-K13 (bf16) and their f32 instances: int8 serving of a bf16 ViT, and
# of an f32 ViT (phase 18's (g)-(i)).
INT8_F32_KERNELS = [name for name, _, _ in KERNELS
                    if name.startswith("int8_") and name.endswith("_f32")
                    and name not in TP_KERNELS]
INT8_KERNELS = [name for name, _, _ in KERNELS if name.startswith("int8_")
                and name not in INT8_F32_KERNELS + TP_KERNELS]
# K6: only the Grad-CAM probe's last block runs it; at f32 (phase 18's
# (j)-(l)), an f32 ViT's probe. These are kept out of F32_KERNELS, whose
# serving and training counts are depth times the forwards.
GRADCAM_KERNELS = ["flash_attention_bhnd", "flash_attention_bhnd_bwd"]
F32_GRADCAM_KERNELS = ["flash_attention_bhnd_f32",
                       "flash_attention_bhnd_bwd_f32"]
# K14, K15: only the ResNet's stem runs them.
RESNET_KERNELS = ["max_pool3d_argmax", "max_pool3d_argmax_bwd"]
# K16-K18: only the probe scripts run them.
PROBE_KERNELS = ["dropout", "gemm_bf16", "gemm_int8", "dynquant_matmul"]
# K1-K5 and K7-K9 at f32: only an f32 ViT runs them (phase 18); serving
# and the 4D step launch the forwards alone.
F32_KERNELS = [name for name, _, _ in KERNELS if name.endswith("_f32")
               and name not in INT8_F32_KERNELS + F32_GRADCAM_KERNELS
               + TP_KERNELS]
F32_BACKWARD_KERNELS = [name for name in F32_KERNELS if "_bwd" in name]
F32_FORWARD_KERNELS = [name for name in F32_KERNELS
                       if name not in F32_BACKWARD_KERNELS]
# Kernels no bf16 ViT block forward or backward launches.
OFF_BLOCK_KERNELS = (INT8_KERNELS + GRADCAM_KERNELS + RESNET_KERNELS
                     + PROBE_KERNELS + F32_KERNELS + INT8_F32_KERNELS
                     + F32_GRADCAM_KERNELS + TP_KERNELS)
# K16's x in its probe (scripts/torch_dropout_bench.py); the GEMM probe's
# shapes are its SHAPES, fc1 first.
DROPOUT_SHAPE = (32 * 1001, 2048)
# The ResNet stem's pool input at batch 8: [B, 90, 45, 45, 64] NDHWC.
POOL_SHAPE = (B, 90, 45, 45, 64)
# The card's peaks for the bound (H100 SXM data sheet, dense): device
# memory bytes/s and operations/s by operand type. f32 products exact to
# f32: three TF32 products each (a big and a small part of the operands)
# at the 495 TF32 TFLOP/s, the fastest f32-accurate route on the card
# (K1, K5 and K6 at f32 take it on mma.sync, the other f32 GEMMs on
# wgmma); F32_FFMA_PER_S, the CUDA cores' f32 rate, is the floor of the
# f32 kernels' first designs on FFMA, printed beside it; F32_MMA_SYNC_PER_S, a third of mma.sync's TF32 rate
# on the H100 (321.8 TFLOP/s, scripts/torch_mma_tf32_peak.py), the
# ceiling of the attention's 3xTF32 products on mma.sync.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 495e12 / 3}
F32_FFMA_PER_S = 67e12
F32_MMA_SYNC_PER_S = 107e12
# The f32 kernels against their plain versions, elementwise: |kernel -
# plain| <= F32_TOL (1 + |plain|), f32 sums taken in another order; the
# f32 model's logits and encodings on the card against the CPU plain path
# within F32_LOGIT_ATOL, six blocks deep.
F32_TOL = 1e-4
F32_LOGIT_ATOL = 1e-3
# The f32 backwards' dgamma and dbeta against plain: relative Frobenius
# error (their sums over the rows taken in another order move them by
# about 1e-7 of their norm). The f32 model's parameter gradients on the
# card against the CPU plain path: relative Frobenius error, worst
# parameter (f32 sums in another order through six blocks and back, where
# a gradient that nearly cancels loses its relative digits first).
F32_PARAM_RTOL = 1e-5
F32_GRAD_RTOL = 1e-3


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
    version's and NaN exactly where it is NaN (a NaN's bits may differ);
    "f32": within F32_TOL (1 + |plain|)."""
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
        elif mode == "f32":
            tol = F32_TOL * (1 + w.abs())
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


def smoke_cli(config, workdir: str, counters: dict, precision: str,
              phase: str) -> dict:
    """The verify recipe's smoke model (dim 64, 4 heads of 16, MLP 128,
    depth 2, 20^3 synthetic cubes) trained for an epoch at ``precision``
    on cuda through ``python -m neurovit_tpu_torch.main``'s main(), which
    must print its training lines and save its checkpoint. Returns the
    run's launch counts."""
    import yaml

    from neurovit_tpu_torch import main as cli

    runs = os.path.join(workdir, f"smoke_runs_{precision}")
    smoke = dict(config, DATASET_NAME="gradcam", DATASET_GENERATE=True,
                 GRADCAM_NUM_SAMPLES=80,
                 GRADCAM_TRAIN_PATH=os.path.join(runs, "train.pkl"),
                 GRADCAM_VAL_PATH=os.path.join(runs, "val.pkl"),
                 TRAINING_VIT_INPUT_SIZE=20, TRAINING_VIT_PATCH_SIZE=5,
                 MODEL_VIT_DIM=64, MODEL_VIT_DEPTH=2, MODEL_VIT_HEADS=4,
                 MODEL_VIT_DIM_HEAD=16, MODEL_VIT_MLP_DIM=128,
                 TRAINING_EPOCHS=1, TRAINING_BATCH_SIZE=8,
                 TRAINING_PRECISION=precision, TRAINING_LEARNING_RATE=1e-3,
                 TRAINING_NUM_WORKERS=2, GRADCAM_SLICE_IDX=10,
                 GLOBAL_OUTPUT_DIR=runs,
                 BEST_MODEL_PATH=os.path.join(runs, "best_model.pkl"))
    path = os.path.join(workdir, f"smoke_{precision}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(smoke, f)
    _reset(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["smoke", "--wandb", "false", "--config", path])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    text = out.getvalue()
    lines = [ln.expandtabs(1) for ln in text.splitlines()]
    for line in lines[-6:]:
        log(phase, f"smoke CLI: {line}")
    if "train_loss" not in text or "MODEL SAVED to" not in text:
        raise AssertionError("the smoke model's CLI run printed no training "
                             "or no checkpoint")
    log(phase, f"smoke model (64, 4 x 16, 128) trained for an epoch in "
        f"{precision} on cuda through the CLI in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def widths_model_phase(config, workdir: str, counters: dict) -> None:
    """The verify recipe's smoke model (dim 64, 4 heads of 16, MLP 128,
    depth 2, 20^3 synthetic cubes) trained for an epoch in bf16 on cuda
    through ``python -m neurovit_tpu_torch.main``'s main(), every bf16
    forward and backward kernel launched; then a ViT-B-width model (dim
    768, 12 heads of 64, MLP 3072, depth cut to 4, 90^3 volumes) served by
    Predictor against the CPU plain path."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.serving import Predictor

    launches = smoke_cli(config, workdir, counters, "bf16", "widths")
    block = [name for name, _, _ in KERNELS if name not in OFF_BLOCK_KERNELS]
    if any(launches[name] == 0 for name in block) or any(
            launches[name] for name in OFF_BLOCK_KERNELS):
        raise AssertionError(f"the smoke CLI run launched {launches}")

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


def device_rows(prof) -> list:
    """(name, device ms, count) of each kernel a torch.profiler trace
    recorded on the card (the attribute's name differs between PyTorch
    versions)."""
    def device_ms(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr) / 1e3
        return 0.0

    return [(e.key, device_ms(e), e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and device_ms(e) > 0]


def profile_split(phase: str, what: str, fn, ms: float) -> None:
    """Kernel time of one ``fn()`` by kernel, from torch.profiler, against
    its timed ``ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
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
    """Each kernel's launches in ``phase`` against ``want``; the forwards'
    weight pre-pass is wanted once for each weight of every K2 f32 (Wqkv),
    K4 f32 (W1, W2) and K3 f32 (Wout) launch, and the backwards' once for
    each weight of every K8 f32 (Wout), K7 f32 (Wqkv) and K9 f32 (W2, W1)
    launch, whatever ``want`` says of them."""
    if "fused_fwd_wsplit_f32" in want:
        want = dict(want, fused_fwd_wsplit_f32=want.get(
            "fused_ln_qkv_f32", 0) + 2 * want.get("fused_mlp_block_f32", 0)
            + want.get("fused_outproj_residual_f32", 0)
            + want.get("fused_outproj_partial_f32", 0)
            + 2 * want.get("fused_mlp_partial_f32", 0))
    if "fused_outproj_bwd_wsplit_f32" in want:
        want = dict(want, fused_outproj_bwd_wsplit_f32=want.get(
            "fused_outproj_bwd_f32", 0) + want.get("fused_ln_qkv_bwd_f32", 0)
            + 2 * want.get("fused_mlp_bwd_f32", 0)
            + 2 * want.get("fused_mlp_bwd_partial_f32", 0))
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


def _fold_against_cpu(model, cpu, x: torch.Tensor, *, phase: str = "4d",
                      edge: int = EDGE_T, atol: float = BF16_LOGIT_ATOL,
                      rtol: float = GRAD_RTOL, encoders=(None, None)) -> tuple:
    """The card's encode_sequence of all B·T volumes of ``x`` against the
    CPU plain path on the first and last ``edge`` timepoints of each
    sequence: the encodings within ``atol`` (the bf16 bound by default),
    and the ViT's last block output (the head's input, [N + 1, dim] a
    volume) by relative Frobenius error per volume within ``rtol``, each
    volume's nearer its own CPU row than any other held volume's, so that
    a row offset in the fold shows. ``encoders``: the ViTs that encode on
    the card and on the CPU in place of the models' own (int8 copies).
    Returns the CPU's (encodings, last block outputs [rows, -1]) of the
    held timepoints."""
    b, t = x.shape[0], x.shape[-1]
    ts = list(range(edge)) + list(range(t - edge, t))
    rows = [i * t + j for i in range(b) for j in ts]
    acts = {}

    def keep(dev, index):
        def hook(_module, _args, out):
            acts[dev] = out[index].float().cpu().reshape(len(rows), -1)
        return hook

    index = torch.tensor(rows, device=x.device)
    for dev, m, vols, vit in (("cuda", model, x, encoders[0]),
                              ("cpu", cpu, x[..., ts].cpu(), encoders[1])):
        vit = vit if vit is not None else m.volume_encoder.vit3d
        handle = vit.transformer.register_forward_hook(
            keep(dev, index if dev == "cuda" else slice(None)))
        t0 = time.perf_counter()
        try:
            enc = m.encode_sequence(vols, encoder=vit)
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
    log(phase, f"(d) the card's fold of {b} x {t} = {b * t} volumes against "
        f"the cpu plain path at timepoints {ts} of each sequence (rows "
        f"{rows}): encodings max diff {diff:.3e} (tol {atol}); "
        f"last block output relative errors {[round(e, 8) for e in errs]} "
        f"(tol {rtol}), each volume nearest its own cpu row {own}, "
        f"the nearest other held volume {float(apart.min()):.3e} apart; cpu "
        f"{cpu_s:.1f} s host clock")
    if not (bool(torch.isfinite(got).all()) and diff <= atol
            and max(errs) <= rtol and own):
        raise AssertionError("the 4D fold differs from the cpu plain path")
    return want, acts["cpu"]


def _cpu_encodings(cpu, vit, vols: torch.Tensor) -> tuple:
    """The CPU model's encode_sequence of ``vols`` [B, ..., T] through the
    ViT ``vit``: (the encodings, the ViT's last block output of each
    volume, [B·T, -1] f32)."""
    acts = []
    handle = vit.transformer.register_forward_hook(
        lambda _module, _args, out: acts.append(
            out.float().reshape(out.shape[0], -1)))
    try:
        with torch.inference_mode():
            enc = cpu.encode_sequence(vols, encoder=vit)
    finally:
        handle.remove()
    return enc, torch.cat(acts)


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
def _f32_kernel_checks(card: str) -> dict:
    """(a) of the f32 phase: K1-K4 at f32 against their plain versions on
    the card at the flagship block (batch 8 x 1001), each case also run
    twice bit-equal, and K2's, K3's and K4's weight pre-pass bit-equal to
    plain; K3 also on all-zero rows of a (y = x + b there, bit for bit)
    and at the 2D tutorial's widths (dim 64, inner 64); the first case of
    each kernel timed beside its plain version, its library yardstick (f32
    SDPA, torch.mm at f32 for each GEMM pass) and its bound; the 3xTF32
    kernels (K1 on mma.sync, K2, K3 and K4 on wgmma) held to F32_CAM_RTOL
    (K3 by y - x, its own part of y) and timed in turns with their
    yardstick. Returns each kernel's stats."""
    import torch.nn.functional as F

    from neurovit_tpu_torch.ops import flash_attention as fa
    from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                        tf32x3)

    rng = np.random.default_rng(SEED + 23)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w(out_f, in_f):                      # nn.Linear's default range
        return torch.tensor(rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
                            dtype=torch.float32, device="cuda")

    inner, m = HEADS * DIM_HEAD, B * N
    scale = DIM_HEAD ** -0.5
    x, attn = t(B, N, DIM), t(B, N, inner)
    qkv = [t(B, N, HEADS, DIM_HEAD) for _ in range(3)]
    ln = (t(DIM, scale=0.1, offset=1.0), t(DIM, scale=0.1))
    zero_ln = (ln[0], torch.zeros_like(ln[1]))
    wqkv, wout, bout = w(3 * inner, DIM), w(DIM, inner), t(DIM, scale=0.03)
    w1, b1, w2, b2 = w(MLP, DIM), t(MLP, scale=0.03), w(DIM, MLP), t(
        DIM, scale=0.02)
    drop = {"dropout_rate": DROPOUT, "seed": 2301}
    mdrop = {"dropout_rate": DROPOUT, "seeds": (2302, 2303)}
    # All-zero rows at a tile's first and last row and in the last tile.
    x0 = x.clone()
    x0[0, [0, 127, 128, 1000]] = 0
    attn0 = attn.clone()
    attn0[0, [0, 127, 128, 1000]] = 0
    # K3 at the 2D tutorial's widths: dim 64, 4 heads of 16, its 197 tokens.
    x_2d, attn_2d = t(B, 197, 64), t(B, 197, 64)
    wout_2d, bout_2d = w(64, 64), t(64, scale=0.03)

    def rows(a, n=130):
        return a[:1, :n].contiguous()

    def attention(q, k, v, **kw):
        return (lambda: fa.flash_attention_f32_cuda(q, k, v, **kw),
                lambda: fa.flash_attention_plain(q, k, v, **kw))

    def ln_qkv(x_, g, b, **kw):
        args = (x_, g, b, wqkv, HEADS, DIM_HEAD)
        return (lambda: fused_qkv.fused_ln_qkv_f32_cuda(*args, **kw),
                lambda: fused_qkv.fused_ln_qkv_plain(*args, **kw))

    def outproj(x_, a, w_=wout, b_=bout, **kw):
        args = (x_, a, w_, b_)
        return (lambda: fused_outproj.fused_outproj_residual_f32_cuda(
            *args, **kw),
            lambda: fused_outproj.fused_outproj_residual_plain(*args, **kw))

    def mlp(x_, g, b, b1_, **kw):
        args = (x_, g, b, w1, b1_, w2, b2)
        return (lambda: fused_mlp.fused_mlp_block_f32_cuda(*args, **kw),
                lambda: fused_mlp.fused_mlp_block_plain(*args, **kw))

    cases = {
        "flash_attention_f32": [
            (f"n_valid {N}", *attention(*qkv, scale=scale, n_valid=N)),
            (f"n_valid {N_VALID_MASKED}",
             *attention(*qkv, scale=scale, n_valid=N_VALID_MASKED)),
            (f"dropout {DROPOUT} with row sums",
             *attention(*qkv, scale=scale, n_valid=N, return_stats=True,
                        **drop))],
        "fused_ln_qkv_f32": [
            ("serving", *ln_qkv(x, *ln)),
            ("with u", *ln_qkv(x, *ln, return_u=True)),
            ("130 rows with u", *ln_qkv(rows(x), *ln, return_u=True)),
            ("zero rows, beta = 0, with u",
             *ln_qkv(x0, *zero_ln, return_u=True))],
        "fused_outproj_residual_f32": [
            ("dropout 0", *outproj(x, attn)),
            (f"dropout {DROPOUT}", *outproj(x, attn, **drop)),
            (f"130 rows, dropout {DROPOUT}",
             *outproj(rows(x), rows(attn), **drop)),
            ("zero rows of a", *outproj(x, attn0)),
            (f"the 2D tutorial's widths (dim 64, inner 64), dropout "
             f"{DROPOUT}", *outproj(x_2d, attn_2d, wout_2d, bout_2d,
                                    **drop))],
        "fused_mlp_block_f32": [
            ("serving", *mlp(x, *ln, b1)),
            (f"dropout {DROPOUT} with h", *mlp(x, *ln, b1, return_h=True,
                                               **mdrop)),
            (f"130 rows with h, dropout {DROPOUT}",
             *mlp(rows(x), *ln, b1, return_h=True, **mdrop)),
            ("zero rows, beta = b1 = 0, with h",
             *mlp(x0, *zero_ln, torch.zeros_like(b1), return_h=True))],
    }
    # Head dims 32, 64 and 128 at a narrow width: batch 2 x 2 heads.
    for d in (32, 64, 128):
        qd = [t(2, N, 2, d) for _ in range(3)]
        cases["flash_attention_f32"].append(
            (f"head dim {d}, batch 2 x 2 heads, dropout {DROPOUT}",
             *attention(*qd, scale=d ** -0.5, n_valid=N, **drop)))
    # K4 f32's, K2 f32's and K3 f32's weight pre-pass: W1, W2, Wqkv, Wout,
    # the 2D tutorial's Wqkv and a ragged weight.
    cases["fused_fwd_wsplit_f32"] = [
        (f"W [{a.shape[0]}, {a.shape[1]}]",
         lambda a=a: tf32x3.split_cuda(a),
         lambda a=a: tf32x3.split_plain(a))
        for a in (w1, w2, wqkv, wout, w(192, 64), w(80, 48))]

    x2, attn2 = x.reshape(m, DIM), attn.reshape(m, inner)
    h2 = t(m, MLP)
    qh, kh, vh = (a.transpose(1, 2) for a in qkv)
    library = {
        "flash_attention_f32": lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale),
        "fused_ln_qkv_f32": lambda: torch.mm(x2, wqkv.t()),
        "fused_outproj_residual_f32": lambda: torch.mm(attn2, wout.t()),
        "fused_mlp_block_f32": lambda: (torch.mm(x2, w1.t()),
                                        torch.mm(h2, w2.t())),
    }
    # (input bytes, operations) of each timed case.
    work = {
        "flash_attention_f32": (nbytes(*qkv), 4 * B * HEADS * N * N
                                * DIM_HEAD),
        "fused_ln_qkv_f32": (nbytes(x, wqkv, *ln), 6 * m * DIM * inner),
        "fused_outproj_residual_f32": (nbytes(x, attn, wout, bout),
                                       2 * m * inner * DIM),
        "fused_mlp_block_f32": (nbytes(x, *ln, w1, b1, w2, b2),
                                4 * m * DIM * MLP),
        # A rounding and a subtraction an element; its bytes bound it.
        "fused_fwd_wsplit_f32": (nbytes(w1), 2 * w1.numel()),
    }

    def zero_rows(name, label, got):
        if not label.startswith("zero rows"):
            return
        zero = [0, 127, 128, 1000]
        if name == "fused_outproj_residual_f32":
            if not torch.equal(got[0].reshape(m, -1)[zero],
                               x2[zero] + bout):
                raise AssertionError("K3 f32 on zero rows of a: y not x + b")
        elif name == "fused_mlp_block_f32":
            y0, h0 = (a_.reshape(m, -1)[zero] for a_ in got)
            if h0.abs().max() or not torch.equal(
                    y0, b2.expand(len(zero), -1)):
                raise AssertionError("K4 f32 on zero rows: h not 0 or y not "
                                     "b2")
        elif got[3].reshape(m, -1)[zero].abs().max():
            raise AssertionError("K2 f32 on zero rows: u not beta")

    stats = _hold_f32_cases(cases, work, library, card, check=zero_rows,
                            exact=("fused_fwd_wsplit_f32",))
    _tf32x3_report("flash_attention_f32", "o", cases["flash_attention_f32"],
                   attention(*qkv, scale=scale, n_valid=N)[0],
                   library["flash_attention_f32"], "f32 SDPA",
                   work["flash_attention_f32"][1], card, mma_sync=True)
    for name, output, library_name in (
            ("fused_mlp_block_f32", "y", "f32 torch.mm at fc1 and fc2"),
            ("fused_ln_qkv_f32", "q", "f32 torch.mm at its GEMM")):
        _tf32x3_report(name, output, cases[name], cases[name][0][1],
                       library[name], library_name, work[name][1], card)
    # K3 f32 by y - x, its own part of y: x's magnitude would hide its
    # error in y's norm.
    name = "fused_outproj_residual_f32"
    residual = [x, x, rows(x), x, x_2d]
    _tf32x3_report(name, "y - x", [
        (label, lambda c=call, r=r: c() - r, lambda p=plain, r=r: p() - r)
        for (label, call, plain), r in zip(cases[name], residual)],
        cases[name][0][1], library[name], "f32 torch.mm at its GEMM",
        work[name][1], card)
    return stats


def _hold_f32_cases(cases: dict, work: dict, library: dict, card: str, *,
                    params: dict = None, check=None,
                    design_ops: dict = None, exact: tuple = ()) -> dict:
    """Each f32 kernel's cases (label, kernel call, plain call) held to
    their plain versions: every output f32 of plain's shape, finite,
    within F32_TOL (1 + |plain|) elementwise, or, at the indices in
    ``params`` (dgamma and dbeta), within F32_PARAM_RTOL relative
    Frobenius error, and two calls bit-equal; ``check(name, label, got)``
    any case's own test. The first case of each kernel (and its dropout
    cases among the first three) timed by CUDA events beside the plain
    version; the first also beside its library call, with its bound from
    ``work`` ((input bytes, operations): 3xTF32 at 165 TFLOP/s) and its
    FFMA floor at 67 TFLOP/s of ``design_ops`` (the operations this
    design takes) or of the operations. The kernels named in ``exact``
    must equal their plain versions bit for bit, and one whose library
    entry is None has no library call (its ``library_ms`` null). Returns
    each kernel's stats."""
    params, design_ops = params or {}, design_ops or {}
    stats = {}
    for name, calls in cases.items():
        max_abs = 0.0
        for i, (label, kernel, plain) in enumerate(calls):
            case_abs = 0.0
            got, want = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
            got = [got] if isinstance(got, torch.Tensor) else list(got)
            want = [want] if isinstance(want, torch.Tensor) else list(want)
            again = [again] if isinstance(again, torch.Tensor) else list(
                again)
            for j, (g, w_, a) in enumerate(zip(got, want, again)):
                g = g.reshape(w_.shape) if g.numel() == w_.numel() else g
                if g.dtype != torch.float32 or g.shape != w_.shape:
                    raise AssertionError(f"{name} {label}: output {j} is "
                                         f"{g.dtype} {tuple(g.shape)}")
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name} {label}: output {j} is "
                                         "not finite")
                diff = (g - w_).abs()
                if j in params.get(name, ()):
                    err = float((g - w_).norm())
                    if err > F32_PARAM_RTOL * float(w_.norm()):
                        raise AssertionError(
                            f"{name} {label}: output {j} relative Frobenius "
                            f"error {err / float(w_.norm()):.3e} > "
                            f"{F32_PARAM_RTOL}")
                elif name in exact:
                    if not torch.equal(g, w_):
                        raise AssertionError(
                            f"{name} {label}: output {j} differs from "
                            f"plain (max abs err {float(diff.max()):.3e}); "
                            "it must equal it bit for bit")
                else:
                    bad = diff > F32_TOL * (1 + w_.abs())
                    if bad.any():
                        raise AssertionError(
                            f"{name} {label}: output {j}: {int(bad.sum())} "
                            f"elements outside the tolerance (max abs err "
                            f"{float(diff.max()):.3e})")
                    case_abs = max(case_abs, float(diff.max()))
                if not torch.equal(g, a.reshape(g.shape)):
                    raise AssertionError(f"{name} {label}: output {j} of two "
                                         "calls differs")
            max_abs = max(max_abs, case_abs)
            if check is not None:
                check(name, label, got)
            msg = f"{name} {label}: max abs err {case_abs:.3e}"
            if i == 0 or "dropout" in label and i < 3:
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                msg += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                if i == 0:
                    in_bytes, ops = work[name]
                    floor_ops = design_ops.get(name, ops)
                    bound_ms, bound_by = bound(in_bytes, nbytes(*got),
                                               {"f32": ops})
                    lib = library.get(name)
                    stats[name] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": None if lib is None else cuda_ms(lib)}
                    if lib is None:
                        msg += (f", no library call, bound {bound_ms:.4f} ms "
                                f"by {bound_by}")
                    else:
                        msg += (f", library call "
                                f"{stats[name]['library_ms']:.4f} ms, bound "
                                f"{bound_ms:.4f} ms by {bound_by} (3xTF32 at "
                                f"165 TFLOP/s, {ops / 1e9:.2f} GFLOP), FFMA "
                                f"floor "
                                f"{floor_ops / F32_FFMA_PER_S * 1e3:.4f} ms "
                                f"({floor_ops / 1e9:.2f} GFLOP at 67 "
                                f"TFLOP/s): {floor_ops / ms / 1e9:.1f} "
                                f"TFLOP/s")
            log("f32", msg + "; bit-equal on a second call")
            del got, want, again
        stats[name]["max_abs_err"] = max_abs
        log("f32", f"{name}: max abs err {max_abs:.3e} over {len(calls)} "
            f"cases (tol {F32_TOL} (1 + |plain|)"
            + (f", dgamma and dbeta {F32_PARAM_RTOL} relative Frobenius"
               if name in params else "") + f"); {card}")
    return stats


def _f32_bwd_kernel_checks(card: str) -> dict:
    """(d) of the f32 phase: K5, K7, K8 and K9 at f32 against their plain
    versions on the card at the flagship block (batch 8 x 1001): K5 at
    n_valid 1001 (dropout 0.1 and 0) and 900, and at head dims 32, 64 and
    128 at batch 2 x 2 heads; K7, K8 and K9 at dropout 0.1 and 0 (K7 has
    none), at 130 rows, and on all-zero rows of dy or dqkv, which give
    dattn = 0, dx = 0 and dz = dh = dx = 0 there. Held and timed by
    ``_hold_f32_cases``: each beside f32 torch.mm at its GEMMs or f32
    SDPA's backward. The backwards' weight pre-pass bit-equal to plain on
    Wout, W2, W1, Wqkv and two narrow weights. K7, K8 and K9 (3xTF32 on
    wgmma) by ``_tf32x3_report``: their first output's relative Frobenius
    error in every case, and their time in turns beside f32 torch.mm."""
    import torch.nn.functional as F

    from neurovit_tpu_torch.ops import flash_attention as fa
    from neurovit_tpu_torch.ops import (fused_mlp, fused_outproj, fused_qkv,
                                        tf32x3)

    rng = np.random.default_rng(SEED + 24)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w(out_f, in_f):                      # nn.Linear's default range
        return torch.tensor(rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
                            dtype=torch.float32, device="cuda")

    inner, m = HEADS * DIM_HEAD, B * N
    scale = DIM_HEAD ** -0.5
    x, dy, h = t(B, N, DIM), t(B, N, DIM), t(B, N, MLP)
    dqkv = t(B, N, 3 * inner)
    qkv = [t(B, N, HEADS, DIM_HEAD) for _ in range(4)]
    ln = (t(DIM, scale=0.1, offset=1.0), t(DIM, scale=0.1))
    wqkv, wout, w1, w2 = w(3 * inner, DIM), w(DIM, inner), w(MLP, DIM), w(
        DIM, MLP)
    zero = [0, 127, 128, 1000]
    dy0, dqkv0 = dy.clone(), dqkv.clone()
    dy0[0, zero] = 0
    dqkv0[0, zero] = 0

    def rows(a, n=130):
        return a[:1, :n].contiguous()

    def attention(q, k, v, do, n_valid, **kw):
        kw = dict(scale=q.shape[-1] ** -0.5, n_valid=n_valid, **kw)
        o, lsum = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
        args = (q, k, v, o, do, lsum)
        return (lambda: fa.flash_attention_bwd_f32_cuda(*args, **kw),
                lambda: fa.flash_attention_bwd_plain(*args, **kw))

    def ln_qkv(d, x_):
        args = (d, x_, ln[0], wqkv)
        return (lambda: fused_qkv.fused_ln_qkv_bwd_f32_cuda(*args),
                lambda: fused_qkv.fused_ln_qkv_bwd_plain(*args))

    def outproj(d, **kw):
        return (lambda: fused_outproj.fused_outproj_bwd_f32_cuda(d, wout,
                                                                 **kw),
                lambda: fused_outproj.fused_outproj_bwd_plain(d, wout, **kw))

    def mlp(d, x_, h_, **kw):
        args = (d, x_, h_, *ln, w1, w2)
        return (lambda: fused_mlp.fused_mlp_bwd_f32_cuda(*args, **kw),
                lambda: fused_mlp.fused_mlp_bwd_plain(*args, **kw))

    drop = {"dropout_rate": DROPOUT, "seed": 2401}
    mdrop = {"dropout_rate": DROPOUT, "seeds": (2402, 2403)}
    cases = {
        "flash_attention_bwd_f32": [
            (f"n_valid {N}, dropout {DROPOUT}", *attention(*qkv, N, **drop)),
            (f"n_valid {N}, dropout 0", *attention(*qkv, N)),
            (f"n_valid {N_VALID_MASKED}, dropout {DROPOUT}",
             *attention(*qkv, N_VALID_MASKED, **drop))],
        "fused_ln_qkv_bwd_f32": [
            ("flagship", *ln_qkv(dqkv, x)),
            ("130 rows", *ln_qkv(rows(dqkv), rows(x))),
            ("zero rows of dqkv", *ln_qkv(dqkv0, x))],
        "fused_outproj_bwd_f32": [
            (f"dropout {DROPOUT}", *outproj(dy, **drop)),
            ("dropout 0", *outproj(dy)),
            (f"130 rows, dropout {DROPOUT}", *outproj(rows(dy), **drop)),
            (f"zero rows of dy, dropout {DROPOUT}", *outproj(dy0, **drop))],
        "fused_mlp_bwd_f32": [
            (f"dropout {DROPOUT}", *mlp(dy, x, h, **mdrop)),
            ("dropout 0", *mlp(dy, x, h)),
            (f"130 rows, dropout {DROPOUT}",
             *mlp(rows(dy), rows(x), rows(h), **mdrop)),
            (f"zero rows of dy, dropout {DROPOUT}",
             *mlp(dy0, x, h, **mdrop))],
    }
    for d in (32, 64, 128):
        qd = [t(2, N, 2, d) for _ in range(4)]
        cases["flash_attention_bwd_f32"].append(
            (f"head dim {d}, batch 2 x 2 heads, dropout {DROPOUT}",
             *attention(*qd, N, **drop)))
    # The backwards' weight pre-pass: Wout, W2, W1, Wqkv, the 2D
    # tutorial's Wout and a ragged weight.
    cases["fused_outproj_bwd_wsplit_f32"] = [
        (f"{name} [{a.shape[0]}, {a.shape[1]}]",
         lambda a=a: tf32x3.split_t_cuda(a),
         lambda a=a: tf32x3.split_t_plain(a))
        for name, a in (("Wout", wout), ("W2", w2), ("W1", w1),
                        ("Wqkv", wqkv), ("W", w(64, 64)), ("W", w(48, 80)))]

    def zero_rows(name, label, got):
        if not label.startswith("zero rows"):
            return
        zeroed = {"fused_ln_qkv_bwd_f32": (0,),
                  "fused_outproj_bwd_f32": (0, 1),
                  "fused_mlp_bwd_f32": (0, 3, 4)}[name]
        for j in zeroed:
            if got[j].reshape(m, -1)[zero].abs().max():
                raise AssertionError(f"{name} on {label}: output {j} not 0 "
                                     "there")

    qh, kh, vh, doh = (a.transpose(1, 2).detach().requires_grad_()
                       for a in qkv)
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    dy2, dqkv2 = dy.reshape(m, DIM), dqkv.reshape(m, 3 * inner)
    dh2 = h.reshape(m, MLP)
    library = {
        "flash_attention_bwd_f32": lambda: torch.autograd.grad(
            sdpa, (qh, kh, vh), doh.detach(), retain_graph=True),
        "fused_ln_qkv_bwd_f32": lambda: torch.mm(dqkv2, wqkv),
        "fused_outproj_bwd_f32": lambda: torch.mm(dy2, wout),
        "fused_mlp_bwd_f32": lambda: (torch.mm(dy2, w2), torch.mm(dh2, w1)),
    }
    q, k, v, do = qkv
    o, lsum = fa.flash_attention_plain(q, k, v, scale=scale,
                                       return_stats=True)
    # (input bytes, operations) of each timed case: K5's five products,
    # which its two passes take as seven (S and dP in each).
    attn_ops = 2 * B * HEADS * N * N * DIM_HEAD
    work = {
        "flash_attention_bwd_f32": (nbytes(q, k, v, o, do, lsum),
                                    5 * attn_ops),
        "fused_ln_qkv_bwd_f32": (nbytes(dqkv, x, ln[0], wqkv),
                                 6 * m * inner * DIM),
        "fused_outproj_bwd_f32": (nbytes(dy, wout), 2 * m * DIM * inner),
        "fused_mlp_bwd_f32": (nbytes(dy, x, h, *ln, w1, w2),
                              4 * m * DIM * MLP),
        # A rounding and a subtraction an element; its bytes bound it.
        "fused_outproj_bwd_wsplit_f32": (nbytes(wout), 2 * wout.numel()),
    }
    stats = _hold_f32_cases(
        cases, work, library, card, check=zero_rows,
        params={"fused_ln_qkv_bwd_f32": (1, 2), "fused_mlp_bwd_f32": (5, 6)},
        design_ops={"flash_attention_bwd_f32": 7 * attn_ops},
        exact=("fused_outproj_bwd_wsplit_f32",))
    _tf32x3_report("(d) fused_outproj_bwd_f32", "dattn",
                   cases["fused_outproj_bwd_f32"], outproj(dy)[0],
                   library["fused_outproj_bwd_f32"], "f32 torch.mm(dy, Wout)",
                   2 * m * DIM * inner, card)
    for name, library_name in (
            ("fused_mlp_bwd_f32", "f32 torch.mm at its two GEMMs"),
            ("fused_ln_qkv_bwd_f32", "f32 torch.mm at its GEMM")):
        _tf32x3_report(f"(d) {name}", "dx", cases[name], cases[name][0][1],
                       library[name], library_name, work[name][1], card)
    return stats


def _tf32x3_report(name: str, output: str, cases: list, kernel, library,
                   library_name: str, flop: int, card: str,
                   mma_sync: bool = False) -> None:
    """An f32 kernel in 3xTF32 (K1 and K6 on mma.sync, K2, K4, K7, K8 and
    K9 on wgmma): its
    first output's relative Frobenius error against plain in each of its
    cases, held below F32_CAM_RTOL; then ``kernel`` at the flagship block
    and the same function's (or K8's GEMM's) PyTorch call ``library``
    timed in turns (kernel, library, library, kernel), with the kernel's
    rate, its share of the 3xTF32 bound (and, on mma.sync, of that form's
    3xTF32 ceiling) and the factor between the two."""
    rels = []
    for label, call, plain in cases:
        got, want = call(), plain()
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        rel = float((got - want).norm() / want.norm())
        if not rel < F32_CAM_RTOL:
            raise AssertionError(f"{name} {label}: {output}'s relative "
                                 f"Frobenius error {rel:.3e} >= "
                                 f"{F32_CAM_RTOL}")
        rels.append(f"{label} {rel:.3e}")
        del got, want
    turns = [cuda_ms(f) for f in (kernel, library, library, kernel)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    bound_ms = flop / PEAK_OPS_PER_S["f32"] * 1e3
    ceiling = (f", {flop / F32_MMA_SYNC_PER_S * 1e3 / ms:.3f} of "
               f"mma.sync's ceiling ({flop / F32_MMA_SYNC_PER_S * 1e3:.4f} "
               f"ms)" if mma_sync else "")
    log("f32", f"{name} (3xTF32 on {'mma.sync' if mma_sync else 'wgmma'}): "
        f"{output}'s relative Frobenius error against plain "
        f"{'; '.join(rels)} (held below {F32_CAM_RTOL}); at the flagship "
        f"block {ms:.4f} ms (turns {turns[0]:.4f}, {turns[3]:.4f}), "
        f"{flop / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the 3xTF32 "
        f"bound ({bound_ms:.4f} ms){ceiling}; {library_name} {lib_ms:.4f} "
        f"ms (turns {turns[1]:.4f}, {turns[2]:.4f}): the kernel takes "
        f"{ms / lib_ms:.3f}x its time; {card}")


# K10-K12 at f32 against their plain versions, f32 phase (g). Both sides
# take the same exact int32 products and round at the same points, but an
# f32 LayerNorm or GELU taken in another order can move one code by one
# step, and one step of one of a row's codes moves that row's outputs by
# up to about 1e-2 (the change passes through a whole GEMM). So each case
# runs again with a scratch kept here and its codes are read back (K10's
# u8, K11's a8, K12's u8 and g8): the positions where they differ from
# plain's are counted, each one step at most and at most
# INT8_F32_FLIP_FRAC of them; the outputs must equal plain's arithmetic on
# the kernel's own codes and row scales bit for bit; and the rows whose
# codes are all plain's own (K12's g8 also against plain's g8 of plain's
# own u8) are held to F32_TOL (1 + |plain|). K11 rounds where plain does
# and is held bit for bit.
INT8_F32_FLIP_FRAC = 1e-3
# K13 at f32 against its plain version (f32 phase (g) and the card test):
# every element within F32_TOL (1 + |plain|) but for a counted few query
# rows. The kernel takes its scores in 3xTF32 on the tensor cores (a fresh
# accumulator every k8 step added in f32), and takes again, in the plain
# version's order (one rounded FMA at a time along D, as the f32 matmul
# sums them), the row max's score and each score whose p / s_p lies near
# a code's rounding boundary: its codes are the plain version's but where
# a 3xTF32 score strays past that window, and its row sums run in another
# order (0 of 64064 rows outside, max abs err 1.5e-7, at the flagship on
# the H100 80GB HBM3 at 700 W). A score summed in another order moves a p
# near a code's rounding boundary to the next code, which moves its row by
# about 4e-3 of the row's largest |o|: 8-17 of 4004 rows (4 heads at N
# 1001, head dims 64 and 128) with the 3xTF32 scores alone in
# tests/test_torch_int8_f32.py's model, 11-17 when the scores are summed
# in f64 and rounded once, 79-87 at head dim 128 with one accumulator over
# D, which this bound refuses. So the query rows outside the bound are
# counted, at most INT8_F32_ATTN_ROW_FRAC of them, and every element is
# held to the bf16 int8 bound ATOL + RTOL |plain| (one code's reach). Two
# faults that bound lets pass, QK^T in TF32 and the denominator taken from
# the codes, put 3591-3640 and 1671-1765 of those 4004 rows outside; (g)
# runs both on the card and fails unless each puts more than the allowance
# outside.
INT8_F32_ATTN_ROW_FRAC = 1e-2
# The f32 int8 model on the card against the CPU plain path, six blocks
# deep (f32 phase (h), (i)). A code flip moves its row by up to 1e-2 (g),
# attention carries a share of it to every row and the next block's codes
# flip in proportion, so any change in the order of an f32 sum moves the
# int8 path's outputs by far more than f32 rounding. The CPU's own path
# shows it: every voxel moved by one ulp moves the flagship's logits by
# 3.246e-3 and config4D's int8 encodings by 3.16e-3 (last block 4.38e-3
# relative), where the card differs from the CPU by 1.954e-3, 4.00e-3 and
# 4.42e-3 (H100 80GB HBM3, 700 W). The limits stand at about 1.5 times the
# larger reading, and (h), (i) hold the CPU's own drift to them too. The
# int8 path's distance from the f32 path is no larger on these random
# weights (1.911e-3 in the logits, 3.43e-3 and 5.44e-3 in 4D), so these
# comparisons cannot tell the two paths apart: the exact launch counts
# and (g) do. The probabilities are held to F32_LOGIT_ATOL.
INT8_F32_LOGIT_ATOL = 5e-3
INT8_F32_FOLD_TOL = 7e-3


def int8_attn_f32_rows(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """K13 at f32's o [B, N, H, D] against plain's: (the query rows (b, n,
    h) with an element outside F32_TOL (1 + |plain|), the rows, whether
    every element is finite and within the bf16 int8 bound ATOL + RTOL
    |plain|)."""
    d = want.shape[-1]
    g, w = got.float().reshape(-1, d), want.float().reshape(-1, d)
    diff = (g - w).abs()
    over = (diff > F32_TOL * (1 + w.abs())).any(dim=1)
    ok = bool(torch.isfinite(g).all()) and not bool(
        (diff > ATOL + RTOL * w.abs()).any())
    return int(over.sum()), over.numel(), ok


def hold_int8_attn_f32(name: str, got: torch.Tensor,
                       want: torch.Tensor) -> int:
    """K13 at f32's o against plain's as INT8_F32_ATTN_ROW_FRAC's comment
    says; raises outside the bounds. Returns the number of query rows
    outside F32_TOL (1 + |plain|)."""
    over, rows, ok = int8_attn_f32_rows(got, want)
    allowed = int(INT8_F32_ATTN_ROW_FRAC * rows)
    if not ok or over > allowed:
        raise AssertionError(
            f"{name}: {over} of {rows} query rows outside F32_TOL (1 + "
            f"|plain|) (at most {allowed}), or an element outside ATOL + "
            f"RTOL |plain|: max abs err "
            f"{float((got.float() - want.float()).abs().max()):.3e}")
    return over


def int8_attn_faults(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, n_valid: int) -> dict:
    """Two faulty K13s at f32 in plain PyTorch, on f32 q, k, v [B, N, H,
    D]: "QK^T in TF32" (q and k rounded to TF32's 10 mantissa bits, to
    nearest with ties away as cvt.rna.tf32.f32 rounds, then the plain
    version) and "the denominator from the codes" (s_p sum(p8) in place of
    the row sum of the exact p). Run them where f32 matmuls are exact to
    f32 (``nn.full_f32``)."""
    from neurovit_tpu_torch.ops import int8_serving as q8

    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1fff).view(torch.float32)

    p8, v8, s_p, _, s_v = q8.attn_codes(q, k, v, scale, n_valid)
    acc = torch.matmul(p8.double(), v8.double()).float()
    codes = acc * (s_p / (s_p * p8.sum(dim=-1, keepdim=True)) * s_v)
    return {"QK^T in TF32": q8.int8_flash_attention_plain(
                tf32(q), tf32(k), v, scale=scale, n_valid=n_valid),
            "the denominator from the codes":
                codes.permute(0, 2, 1, 3).contiguous()}


def _int8_f32_own_codes(name: str, args: tuple, got):
    """(g): run the f32 int8 kernel ``name`` (K10, K11 or K12) again on
    ``args`` with a scratch kept here and read its codes and row scales
    back. Its outputs must be the wrapper's ``got`` bit for bit and (K10,
    K12) plain's arithmetic on its own codes and row scales bit for bit,
    its codes within one step of plain's as INT8_F32_FLIP_FRAC's comment
    says. Returns (the flipped codes' count, the rows [m] where a code
    differs from plain's own, how many of them K12's g8 alone marks: g8
    the GELU of its own u8's product, but not plain's g8)."""
    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.ops import int8_serving as q8

    x = args[0]
    dim = x.shape[-1]
    m = x.numel() // dim
    if name == "int8_ln_qkv_f32":
        plan = q8.qkv_plan(m, dim, args[5] * args[6])
    elif name == "int8_outproj_residual_f32":
        plan = q8.int8_outproj_plan(m, dim, args[1].shape[-1])
    else:
        plan = q8.mlp_plan(m, dim, args[3].shape[0])
    scratch = torch.zeros(plan.scratch_bytes, dtype=torch.uint8,
                          device="cuda")
    outs = getattr(q8, name + "_cuda")(*args, scratch=scratch)
    torch.cuda.synchronize()

    def piece(key, dtype, cols):
        at, n = plan.scratch[key]
        return scratch[at:at + n].view(dtype).reshape(-1, cols)

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
    if not all(torch.equal(a, b) for a, b in zip(outs, got)):
        raise AssertionError(f"{name}: the scratch's call and the wrapper's "
                             "differ")
    pairs, g8_rows, exact = [], None, True
    with nn.full_f32(torch.float32):
        if name == "int8_outproj_residual_f32":
            a = args[1]
            pairs.append((piece("a8", torch.int8, a.shape[-1]),
                          q8._rowquant(a.float())[0]))
        else:
            u8 = piece("u8", torch.int8, dim)
            codes, s_row = q8._rowquant(q8._ln(x, args[1], args[2]))
            pairs.append((u8, codes))
        if name == "int8_ln_qkv_f32":
            _, _, _, w8, sc, heads, dh = args
            mine = q8._deq_dot(u8.float(), piece("s_row", torch.float32, 1),
                               w8, sc).reshape(m, 3, heads * dh)
            exact = all(torch.equal(g.reshape(m, -1), mine[:, i])
                        for i, g in enumerate(outs))
        elif name == "int8_mlp_block_f32":
            _, _, _, w1, s1, b1, w2, s2, b2 = args
            g8 = piece("g8", torch.int8, w1.shape[0])
            h = q8._deq_dot(u8.float(), piece("s1_row", torch.float32, 1),
                            w1, s1) + b1
            pairs.append((g8, q8._rowquant(nn.gelu(h))[0]))
            h = q8._deq_dot(codes, s_row, w1, s1) + b1   # plain's own h
            g8_rows = (g8.float() != q8._rowquant(nn.gelu(h))[0].reshape(
                g8.shape)).any(dim=1)
            mine = (q8._deq_dot(g8.float(), piece("s2_row", torch.float32, 1),
                                w2, s2) + b2 + x.reshape(m, dim))
            exact = torch.equal(outs[0].reshape(m, dim), mine)
    if not exact:
        raise AssertionError(f"{name}: the outputs are not plain's arithmetic "
                             "on the kernel's own codes")
    flips, rows = 0, torch.zeros(m, dtype=torch.bool, device="cuda")
    for codes, want in pairs:
        diff = (codes.long() - want.reshape(codes.shape).long()).abs()
        n = int(diff.sum())
        if int(diff.max()) > 1 or n > INT8_F32_FLIP_FRAC * diff.numel():
            raise AssertionError(f"{name}: codes differ from plain's by up to "
                                 f"{int(diff.max())} steps at {n} of "
                                 f"{diff.numel()} positions")
        flips += n
        rows |= diff.any(dim=1)
    g8_only = 0 if g8_rows is None else int((g8_rows & ~rows).sum())
    return flips, rows if g8_rows is None else rows | g8_rows, g8_only


def _int8_f32_kernel_checks(card: str) -> dict:
    """(g) of the f32 phase: K10-K13 at f32 against their plain versions
    (at "highest" precision) on the card at the flagship block (batch 8 x
    1001): K10 serving, at 130 rows and on all-zero rows with beta = 0; K11
    there, at 130 rows and on all-zero rows of a; K12 serving, at 130 rows
    and on all-zero rows with beta = b1 = 0; K13 at n_valid 1001 and 900
    and at head dims 32, 64 and 128 at batch 2 x 2 heads. Held as
    INT8_F32_FLIP_FRAC's and INT8_F32_ATTN_ROW_FRAC's comments say (K13's
    n_valid cases also against its two faulty versions,
    :func:`int8_attn_faults`), two calls bit-equal; the first case
    of each timed beside plain, torch._int_mm at its GEMMs (K13: its device
    split by the profiler beside K1 at f32 on the same inputs, its design
    floor and the first design's FFMA floor), with
    its bound. Returns each kernel's stats."""
    from neurovit_tpu_torch import nn
    from neurovit_tpu_torch.ops import int8_serving as q8

    rng = np.random.default_rng(SEED + 25)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(shape),
                            dtype=torch.float32, device="cuda")

    def w8(out_f, in_f):                     # nn.Linear's default range
        return q8.quantize_weight(torch.tensor(
            rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5,
            dtype=torch.float32, device="cuda"))

    inner, m, zero = HEADS * DIM_HEAD, B * N, [0, 127, 128, 1000]
    scale = DIM_HEAD ** -0.5
    x, attn = t(B, N, DIM), t(B, N, inner)
    qkv = [t(B, N, HEADS, DIM_HEAD) for _ in range(3)]
    ln = (t(DIM, scale=0.1, offset=1.0), t(DIM, scale=0.1))
    zero_ln = (ln[0], torch.zeros_like(ln[1]))
    qkv8, out8, bout = w8(3 * inner, DIM), w8(DIM, inner), t(DIM, scale=0.03)
    mlp8 = (*w8(MLP, DIM), t(MLP, scale=0.03), *w8(DIM, MLP),
            t(DIM, scale=0.02))
    zero_mlp = mlp8[:2] + (torch.zeros_like(mlp8[2]),) + mlp8[3:]
    x0, a0 = x.clone(), attn.clone()
    x0[0, zero] = 0
    a0[0, zero] = 0

    def rows(a, n=130):
        return a[:1, :n].contiguous()

    def case(label, op, *args, **kw):
        kernel, plain = (getattr(q8, op + "_f32_cuda"),
                         getattr(q8, op + "_plain"))

        def run_plain():
            with nn.full_f32(torch.float32):
                return plain(*args, **kw)
        return label, args, kw, (lambda: kernel(*args, **kw)), run_plain

    heads = (HEADS, DIM_HEAD)
    cases = {
        "int8_ln_qkv_f32": [
            case("serving", "int8_ln_qkv", x, *ln, *qkv8, *heads),
            case("130 rows", "int8_ln_qkv", rows(x), *ln, *qkv8, *heads),
            case("zero rows, beta = 0", "int8_ln_qkv", x0, *zero_ln, *qkv8,
                 *heads)],
        "int8_outproj_residual_f32": [
            case("flagship", "int8_outproj_residual", x, attn, *out8, bout),
            case("130 rows", "int8_outproj_residual", rows(x), rows(attn),
                 *out8, bout),
            case("zero rows of a", "int8_outproj_residual", x, a0, *out8,
                 bout)],
        "int8_mlp_block_f32": [
            case("serving", "int8_mlp_block", x, *ln, *mlp8),
            case("130 rows", "int8_mlp_block", rows(x), *ln, *mlp8),
            case("zero rows, beta = b1 = 0", "int8_mlp_block", x0, *zero_ln,
                 *zero_mlp)],
        "int8_flash_attention_f32": [
            case(f"n_valid {N}", "int8_flash_attention", *qkv, scale=scale,
                 n_valid=N),
            case(f"n_valid {N_VALID_MASKED}", "int8_flash_attention", *qkv,
                 scale=scale, n_valid=N_VALID_MASKED)],
    }
    for d in (32, 64, 128):
        qd = [t(2, N, 2, d) for _ in range(3)]
        cases["int8_flash_attention_f32"].append(case(
            f"head dim {d}, batch 2 x 2 heads", "int8_flash_attention", *qd,
            scale=d ** -0.5, n_valid=N))

    # The inputs and operations of each first case, for its bound; QK^T is
    # f32 (3xTF32 at 165 TFLOP/s), P V int8.
    att = 2 * B * HEADS * N * N * DIM_HEAD
    work = {
        "int8_ln_qkv_f32": (nbytes(x, *ln, *qkv8),
                            {"int8": 2 * m * DIM * 3 * inner}),
        "int8_outproj_residual_f32": (nbytes(x, attn, *out8, bout),
                                      {"int8": 2 * m * inner * DIM}),
        "int8_mlp_block_f32": (nbytes(x, *ln, *mlp8),
                               {"int8": 4 * m * DIM * MLP}),
        "int8_flash_attention_f32": (nbytes(*qkv), {"f32": att, "int8": att}),
    }
    # The library yardstick: torch._int_mm at each GEMM on int8 codes of
    # the GEMM's shapes.
    int_mm = script("torch_int8_gemm_bench").library_int_mm
    u8, a8, g8 = (torch.randint(-127, 128, (m, k), dtype=torch.int8,
                                device="cuda") for k in (DIM, inner, MLP))
    gemms = {
        "int8_ln_qkv_f32": [int_mm(u8, qkv8[0].t())],
        "int8_outproj_residual_f32": [int_mm(a8, out8[0].t())],
        "int8_mlp_block_f32": [int_mm(u8, mlp8[0].t()),
                               int_mm(g8, mlp8[3].t())],
    }
    library = {name: (None if name not in gemms
                      or any(fn is None for fn in gemms[name])
                      else (lambda fns=gemms[name]: [fn() for fn in fns]))
               for name in cases}
    stats = {}
    for name, calls in cases.items():
        max_abs, flips_total, over_total = 0.0, 0, 0
        for i, (label, args, kw, kernel, plain) in enumerate(calls):
            got, want = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
            outs = [got] if isinstance(got, torch.Tensor) else list(got)
            if any(o.dtype != torch.float32 for o in outs):
                raise AssertionError(f"{name} {label}: not f32 outputs")
            if not all(torch.equal(a, b) for a, b in zip(
                    outs, [again] if isinstance(again, torch.Tensor)
                    else again)):
                raise AssertionError(f"{name} {label}: two calls differ")
            wants = [want] if isinstance(want, torch.Tensor) else list(want)
            if name == "int8_outproj_residual_f32":
                compare(f"{name} {label}", outs, wants, mode="exact")
            if name == "int8_flash_attention_f32":
                a = float((got - want).abs().max())
                over = hold_int8_attn_f32(f"{name} {label}", got, want)
                rows = want.numel() // want.shape[-1]
                over_total += over
                allowed = int(INT8_F32_ATTN_ROW_FRAC * rows)
                msg = (f"{name} {label}: max abs err {a:.3e}; {over} of "
                       f"{rows} query rows outside F32_TOL (1 + |plain|) (at "
                       f"most {allowed}); bit-equal on a second call")
                if label.startswith("n_valid"):
                    with nn.full_f32(torch.float32):
                        faults = int8_attn_faults(*args, **kw)
                    for fault, o in faults.items():
                        n_over, _, _ = int8_attn_f32_rows(o, want)
                        msg += (f"; {fault}: {n_over} rows outside, max abs "
                                f"err {float((o - want).abs().max()):.3e}")
                        if n_over <= allowed:
                            raise AssertionError(f"{name} {label}: the bound "
                                                 f"does not see {fault}")
                    del faults
            else:
                flips, flipped, g8_only = _int8_f32_own_codes(name, args, got)
                a = max(float((o.reshape(w_.shape) - w_).abs().max())
                        for o, w_ in zip(outs, wants))
                keep = ~flipped
                clean, _ = compare(
                    f"{name} {label}, the rows whose codes are plain's",
                    [o.reshape(keep.numel(), -1)[keep] for o in outs],
                    [w_.reshape(keep.numel(), -1)[keep] for w_ in wants],
                    mode="f32")
                msg = (f"{name} {label}: max abs err {a:.3e}, on the "
                       f"{int(keep.sum())} of {keep.numel()} rows whose codes "
                       f"are plain's {clean:.3e} (tol F32_TOL (1 + |plain|)); "
                       f"{flips} codes one step from plain's")
                if name == "int8_mlp_block_f32":
                    msg += (f"; {g8_only} rows whose g8 differs from plain's "
                            "own g8 alone")
                msg += "; bit-equal on a second call"
                flips_total += flips
            max_abs = max(max_abs, a)
            if label.startswith("zero rows"):
                zero_out = [o.reshape(m, -1)[zero] for o in outs]
                ok = (all(not z.abs().max() for z in zero_out)
                      if name == "int8_ln_qkv_f32" else
                      torch.equal(zero_out[0], (bout + x[0, zero]))
                      if name == "int8_outproj_residual_f32" else
                      torch.equal(zero_out[0],
                                  mlp8[-1].expand(len(zero), -1)))
                if not ok:
                    raise AssertionError(f"{name} {label}: the zero rows")
                msg += "; the zero rows exact"
            if i == 0:
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                in_bytes, ops = work[name]
                bound_ms, bound_by = bound(in_bytes, nbytes(*outs), ops)
                lib = library[name]
                stats[name] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": cuda_ms(lib) if lib else None}
                msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"torch._int_mm at its GEMMs "
                        f"{stats[name]['library_ms']} ms, bound "
                        f"{bound_ms:.4f} ms by {bound_by}")
                if name == "int8_flash_attention_f32":
                    # The device split (the V prologue's two passes, the
                    # attention) beside K1 at f32 on the same inputs.
                    m = script("torch_int8_attention_device_times").measure(
                        qkv, N, 10)
                    stats[name]["device_ms"] = m["device_ms"]
                    msg += "; " + script(
                        "torch_int8_attention_device_times").f32_line(
                            B, DIM_HEAD, N, m)
            log("f32", msg)
            del got, want, again, outs, wants
        stats[name]["max_abs_err"] = max_abs
        held = (f"{over_total} query rows outside F32_TOL (1 + |plain|) in all"
                if name == "int8_flash_attention_f32" else
                f"the rows whose codes are plain's within F32_TOL (1 + "
                f"|plain|); {flips_total} codes one step off in all")
        log("f32", f"(g) {name}: max abs err {max_abs:.3e} over {len(calls)} "
            f"cases ({held}); {card}")
    return stats


def _int8_f32_serving(fcfg, ckpt: str, workdir: str, card: str,
                      counters: dict) -> dict:
    """(h) of the f32 phase: the seed-42 flagship at f32 served with
    quant="int8" through Predictor (every bucket, 3 volumes), one HTTP
    POST and the batch CLI with --quant int8: each f32 int8 kernel
    launched depth times per forward of the model, nothing else; one
    forward with SERVING_INT8_ATTN off (K1 at f32 in place of K13); the
    logits of 3 volumes against the CPU's f32 int8 path within
    INT8_F32_LOGIT_ATOL, as the CPU's own logits with every voxel moved by
    one ulp, and its probabilities within F32_LOGIT_ATOL; int8 against f32
    logits read; the probabilities against f32 serving within INT8_ATOL
    (the JAX test's bound); the forward at batch 32 timed with a profiler
    split. Returns the launch counts."""
    import yaml

    from neurovit_tpu_torch import serving
    from neurovit_tpu_torch.data import nifti
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    from neurovit_tpu_torch.serving import Predictor, _collect_volume_jobs
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    phase, depth = "f32", fcfg["MODEL_VIT_DEPTH"]
    size = fcfg["TRAINING_VIT_INPUT_SIZE"]
    rng = np.random.default_rng(SEED + 26)
    path = os.path.join(workdir, "scan_f32_int8.nii")
    nifti.save(path, rng.standard_normal((91, 109, 91)).astype(np.float32))
    cfg_path = os.path.join(workdir, "config_f32.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(fcfg, f)
    out = os.path.join(workdir, "pred_f32_int8.csv")
    # Every forward of any NeuroEncoder, the CLI's own model's too.
    forwards, forward = [0], NeuroEncoder.forward

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return forward(self, *args, **kwargs)

    predictor = Predictor.from_checkpoint(fcfg, ckpt, batch_size=32,
                                          device="cuda", quant="int8")
    vols = _volumes(rng, 3, size)
    NeuroEncoder.forward = counted
    try:
        _reset(counters)
        predictor.warmup()
        _, probs = predictor(vols)
        http_phase(predictor, rng, workdir, n_files=1, concurrent=False)
        with contextlib.redirect_stdout(io.StringIO()):
            serving.main([path, "--config", cfg_path, "--checkpoint", ckpt,
                          "--output", out, "--quant", "int8"])
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        NeuroEncoder.forward = forward
    log(phase, f"(h) f32 int8 serving: warmup of buckets "
        f"{predictor.bucket_sizes}, 3 volumes, one POST, the batch CLI with "
        f"--quant int8: {forwards[0]} forward calls x depth {depth}; "
        f"launches {launches}")
    _check_counts("f32 int8 serving", launches,
                  _want(INT8_F32_KERNELS, depth * forwards[0], counters))
    with open(out) as f:
        row = f.read().strip().splitlines()[1].split(",")
    _, _, vol = next(_collect_volume_jobs([path], crop=True))
    diff = float(np.abs(np.array([float(v) for v in row[3:]])
                        - predictor(vol[None])[1][0]).max())
    log(phase, f"(h) the batch CLI's row {row[1:]}: max diff vs Predictor "
        f"{diff:.3e} (tol {PROB_ATOL})")
    if diff > PROB_ATOL:
        raise AssertionError(f"the f32 int8 CLI differs by {diff}")

    off = Predictor.from_checkpoint(dict(fcfg, SERVING_INT8_ATTN=False),
                                    ckpt, batch_size=1, bucket_sizes=(),
                                    device="cuda", quant="int8")
    _reset(counters)
    _, got_off = off(vols[:1])
    counts = {name: fn.launches for name, fn in counters.items()}
    _check_counts("the f32 SERVING_INT8_ATTN: off forward", counts, {
        name: depth if name in ("int8_ln_qkv_f32",
                                "int8_outproj_residual_f32",
                                "int8_mlp_block_f32", "flash_attention_f32")
        else 0 for name in counters})
    for name, n in counts.items():
        launches[name] += n
    del off

    cpu = NeuroEncoder(fcfg, device="cpu", seed=SEED + 5).eval()
    load_checkpoint(cpu, ckpt, strict=True)
    quantize_blocks(cpu.volume_encoder.vit3d)
    f32 = Predictor.from_checkpoint(fcfg, ckpt, batch_size=32, device="cuda")
    _, want_f32 = f32(vols)
    moved = np.nextafter(vols, np.float32(np.inf))
    with torch.inference_mode():
        want = cpu(torch.from_numpy(vols))
        witness = cpu(torch.from_numpy(moved))
        got = predictor.model(torch.from_numpy(vols).cuda()).cpu()
        got_f32 = f32.model(torch.from_numpy(vols).cuda()).cpu()
    diff = float((got - want).abs().max())
    wdiff = float((witness - want).abs().max())
    fdiff = float((got - got_f32).abs().max())
    cdiff = float(np.abs(probs - torch.softmax(want, -1).numpy()).max())
    pdiff = float(np.abs(probs - want_f32).max())
    odiff = float(np.abs(got_off[0] - probs[0]).max())
    log(phase, f"(h) f32 int8 logits of 3 volumes, cuda {got.tolist()} vs "
        f"cpu {want.tolist()}: max diff {diff:.3e}, the cpu against itself "
        f"with every voxel moved by one ulp {wdiff:.3e} (tol "
        f"{INT8_F32_LOGIT_ATOL}); int8 against f32 logits on the card "
        f"{fdiff:.3e}; Predictor's probabilities against the cpu "
        f"{cdiff:.3e} (tol {F32_LOGIT_ATOL}); probabilities against f32 "
        f"serving {pdiff:.3e} (tol {INT8_ATOL}); SERVING_INT8_ATTN off "
        f"against pv {odiff:.3e} (tol {INT8_ATOL})")
    if (not torch.isfinite(got).all()
            or max(diff, wdiff) > INT8_F32_LOGIT_ATOL
            or cdiff > F32_LOGIT_ATOL or max(pdiff, odiff) > INT8_ATOL):
        raise AssertionError("f32 int8 serving differs from the cpu or from "
                             "f32 serving")
    del cpu, f32
    x32 = torch.from_numpy(_volumes(rng, 32, size)).cuda()
    model = predictor.model
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x32), warmup=2, runs=5)
        log(phase, f"(h) f32 int8 forward at batch 32: {ms:.3f} ms, "
            f"{32 / ms * 1e3:.1f} vol/s; {card}")
        profile_split(phase, "f32 int8 forward at batch 32",
                      lambda: model(x32), ms)
    del predictor, model, x32
    torch.cuda.empty_cache()
    return launches


def _int8_f32_fourd(workdir: str, card: str, counters: dict) -> dict:
    """(i) of the f32 phase: config4D at f32 with TRAINING_4D_ENCODER_QUANT
    int8 (B 2 x T 140): Trainer.run() of one epoch (two steps), then again
    with the feature cache; each run's launches (each f32 int8 kernel depth
    times per encoder forward, nothing else), the losses of the two runs
    equal, the step and the encoder timed, peak memory; the int8
    encodings and the last block's output of the first and last timepoint
    of each sequence against the CPU's f32 int8 path within
    INT8_F32_FOLD_TOL, as the CPU's own with every voxel moved by one ulp;
    the f32 encoder's distance read. Returns the launch counts."""
    import copy

    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.models.vit3d import quantize_blocks
    from neurovit_tpu_torch.training import Trainer

    phase = "f32"
    total = {name: 0 for name in counters}
    runs = {}
    for cache in (False, True):
        cfg = _fourd_config(
            workdir, TRAINING_PRECISION="f32", TRAINING_EPOCHS=1,
            TRAINING_4D_ENCODER_QUANT="int8",
            TRAINING_4D_FEATURE_CACHE=cache,
            TRAINING_4D_FEATURE_CACHE_DIR=os.path.join(workdir,
                                                       "cache_f32_int8"),
            GLOBAL_OUTPUT_DIR=os.path.join(workdir, f"runs4d_f32_int8_{cache}"))
        depth, size = cfg["MODEL_VIT_DEPTH"], cfg["TRAINING_VIT_INPUT_SIZE"]
        model = NeuroEncoder(cfg, device="cuda", seed=SEED)
        trainer = Trainer(cfg, model, _SeededSequences(4, size, SEQ_T, SEED,
                                                       "train4d"),
                          _SeededSequences(2, size, SEQ_T, SEED + 1, "val4d"))
        forwards = _count_forwards(trainer._q8_encoder)
        losses, launches, _ = _run_trainer(trainer, counters)
        what = "with the feature cache" if cache else "uncached"
        log(phase, f"(i) f32 4D run with the int8 encoder, {what}: losses "
            f"{losses}; {forwards[0]} encoder forwards x depth {depth}; "
            f"launches {launches}")
        _check_counts(f"the f32 int8 4D run {what}", launches,
                      _want(INT8_F32_KERNELS, depth * forwards[0], counters))
        for name, n in launches.items():
            total[name] += n
        runs[cache] = (trainer, model, losses)
    log(phase, f"(i) cached against uncached losses: {runs[True][2]} vs "
        f"{runs[False][2]}, held equal")
    if runs[True][2] != runs[False][2]:
        raise AssertionError("the cached f32 int8 4D losses differ")
    trainer, model, _ = runs[False]
    del runs
    batch, _, _ = next(trainer._device_prefetch(trainer.val_dataloader))
    q8 = trainer._q8_encoder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_step(batch), 1, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    enc_ms = cuda_ms(lambda: model.encode_sequence(batch["volume"],
                                                   encoder=q8), 1, 3)
    vols = batch["volume"].shape[0] * batch["volume"].shape[-1]
    log(phase, f"(i) f32 4D train step with the int8 encoder at B 2 x T "
        f"{SEQ_T} ({vols} volumes): {step_ms:.3f} ms "
        f"({vols / step_ms * 1e3:.1f} vol/s), the encoder {enc_ms:.3f} ms = "
        f"{100 * enc_ms / step_ms:.1f} % of it; peak memory {peak:.2f} GiB; "
        f"{card}")
    cfg = trainer.config
    cpu = NeuroEncoder(cfg, device="cpu", seed=SEED + 2)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_q8 = quantize_blocks(copy.deepcopy(cpu.volume_encoder.vit3d))
    want, acts = _fold_against_cpu(model, cpu, batch["volume"], phase=phase,
                                   edge=1, atol=INT8_F32_FOLD_TOL,
                                   rtol=INT8_F32_FOLD_TOL,
                                   encoders=(q8, cpu_q8))
    # The CPU's own drift (every voxel moved by one ulp), held to the same
    # limits, and the f32 encoder's distance on the same volumes.
    xs = batch["volume"][..., [0, batch["volume"].shape[-1] - 1]].cpu()
    readings = {}
    for what, vit, x_in in (
            ("moved by one ulp", cpu_q8,
             torch.nextafter(xs, torch.full_like(xs, float("inf")))),
            ("the f32 encoder", cpu.volume_encoder.vit3d, xs)):
        enc, act = _cpu_encodings(cpu, vit, x_in)
        readings[what] = (float((enc - want).abs().max()), float(
            ((act - acts).norm(dim=1) / acts.norm(dim=1)).max()))
    log(phase, f"(i) the cpu's int8 encodings and last block outputs "
        f"(max diff, worst relative error) against themselves "
        f"with every voxel moved by one ulp {readings['moved by one ulp']}, "
        f"(tol {INT8_F32_FOLD_TOL}), against the f32 encoder "
        f"{readings['the f32 encoder']}")
    if max(readings["moved by one ulp"]) > INT8_F32_FOLD_TOL:
        raise AssertionError("the cpu's own int8 drift passes the 4D fold's "
                             "limit")
    del trainer, model, cpu, cpu_q8, batch
    torch.cuda.empty_cache()
    return total


def _k6_f32_kernel_checks(card: str) -> dict:
    """(j) of the f32 phase: K6 and its backward at f32 against their plain
    versions on the card, by ``_hold_f32_cases``: the flagship probe's
    block in [B, H, N, D] (batch 8 x 8 heads x 1001 x 64) at dropout 0
    and 0.1 and at n_valid 900, head dims 16 (padded to 32), 32, 64 and
    128 at batch 2 x 2 heads, and the 2D tutorial's probe block [2, 4,
    197, 16]; the first case of each timed beside
    plain, f32 SDPA (forward) or its backward, and the bound. The first
    case is also run through K1 or K5 at f32 on the same heads in
    [B, N, H, D] and timed: one kernel in two layouts, bit-equal."""
    import torch.nn.functional as F

    from neurovit_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(SEED + 26)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")

    def fwd(q, k, v, **kw):
        kw = dict(scale=q.shape[-1] ** -0.5, **kw)
        return (lambda: fa.flash_attention_bhnd_f32_cuda(q, k, v, **kw),
                lambda: fa.flash_attention_bhnd_plain(q, k, v, **kw))

    def bwd(q, k, v, do, n_valid, **kw):
        kw = dict(scale=q.shape[-1] ** -0.5, n_valid=n_valid, **kw)
        o, lsum = fa.flash_attention_bhnd_plain(q, k, v, return_stats=True,
                                                **kw)
        args = (q, k, v, o, do, lsum)
        return (lambda: fa.flash_attention_bhnd_bwd_f32_cuda(*args, **kw),
                lambda: fa.flash_attention_bhnd_bwd_plain(*args, **kw))

    scale = DIM_HEAD ** -0.5
    q, k, v, do = (t(B, HEADS, N, DIM_HEAD) for _ in range(4))
    drop = {"dropout_rate": DROPOUT, "seed": 2601}
    cases = {
        "flash_attention_bhnd_f32": [
            (f"n_valid {N}, dropout 0", *fwd(q, k, v, n_valid=N)),
            (f"dropout {DROPOUT} with row sums",
             *fwd(q, k, v, n_valid=N, return_stats=True, **drop)),
            (f"n_valid {N_VALID_MASKED}",
             *fwd(q, k, v, n_valid=N_VALID_MASKED))],
        "flash_attention_bhnd_bwd_f32": [
            (f"n_valid {N}, dropout 0", *bwd(q, k, v, do, N)),
            (f"n_valid {N}, dropout {DROPOUT}", *bwd(q, k, v, do, N, **drop)),
            (f"n_valid {N_VALID_MASKED}, dropout 0",
             *bwd(q, k, v, do, N_VALID_MASKED))],
    }
    for d in (16, 32, 64, 128):
        qd = [t(2, 2, N, d) for _ in range(4)]
        label = f"head dim {d}, batch 2 x 2 heads, dropout {DROPOUT}"
        cases["flash_attention_bhnd_f32"].append(
            (label, *fwd(*qd[:3], n_valid=N, **drop)))
        cases["flash_attention_bhnd_bwd_f32"].append(
            (label, *bwd(*qd, N, **drop)))
    # The 2D tutorial's probe: 2 squares x 4 heads x 197 tokens x 16,
    # ragged for the 64-row query and 32-key tiles, no dropout.
    q2d = [t(2, 4, 197, 16) for _ in range(4)]
    label = "the 2D probe's [2, 4, 197, 16], dropout 0"
    cases["flash_attention_bhnd_f32"].append(
        (label, *fwd(*q2d[:3], n_valid=197)))
    cases["flash_attention_bhnd_bwd_f32"].append((label, *bwd(*q2d, 197)))

    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)
    library = {
        "flash_attention_bhnd_f32": lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale),
        "flash_attention_bhnd_bwd_f32": lambda: torch.autograd.grad(
            sdpa, leaves, do, retain_graph=True),
    }
    o, lsum = fa.flash_attention_bhnd_plain(q, k, v, scale=scale,
                                            return_stats=True)
    attn_ops = 2 * B * HEADS * N * N * DIM_HEAD
    work = {
        "flash_attention_bhnd_f32": (nbytes(q, k, v), 2 * attn_ops),
        "flash_attention_bhnd_bwd_f32": (nbytes(q, k, v, o, do, lsum),
                                         5 * attn_ops),
    }
    stats = _hold_f32_cases(
        cases, work, library, card,
        design_ops={"flash_attention_bhnd_bwd_f32": 7 * attn_ops})
    _tf32x3_report("(j) flash_attention_bhnd_f32", "o",
                   cases["flash_attention_bhnd_f32"],
                   fwd(q, k, v, n_valid=N)[0],
                   library["flash_attention_bhnd_f32"], "f32 SDPA",
                   2 * attn_ops, card, mma_sync=True)

    # One kernel in two layouts: K6 f32 against K1 / K5 f32 on the same
    # heads laid out [B, N, H, D], bit for bit, each timed.
    def bnhd(a):
        return a.transpose(1, 2).contiguous()

    kw = {"scale": scale, "n_valid": N}
    pairs = {
        "flash_attention_bhnd_f32": (
            lambda: fa.flash_attention_bhnd_f32_cuda(q, k, v, **kw),
            lambda: fa.flash_attention_f32_cuda(bnhd(q), bnhd(k), bnhd(v),
                                                **kw)),
        "flash_attention_bhnd_bwd_f32": (
            lambda: fa.flash_attention_bhnd_bwd_f32_cuda(q, k, v, o, do,
                                                         lsum, **kw),
            lambda: fa.flash_attention_bwd_f32_cuda(
                *(bnhd(a) for a in (q, k, v, o, do)), lsum, **kw)),
    }
    qn, kn, vn, on, don = (bnhd(a) for a in (q, k, v, o, do))
    timed_bnhd = {
        "flash_attention_bhnd_f32": lambda: fa.flash_attention_f32_cuda(
            qn, kn, vn, **kw),
        "flash_attention_bhnd_bwd_f32":
            lambda: fa.flash_attention_bwd_f32_cuda(qn, kn, vn, on, don,
                                                    lsum, **kw),
    }
    for name, (bhnd_call, bnhd_call) in pairs.items():
        got, other = bhnd_call(), bnhd_call()
        got = [got] if isinstance(got, torch.Tensor) else list(got)
        other = [other] if isinstance(other, torch.Tensor) else list(other)
        if not all(torch.equal(g, a.transpose(1, 2))
                   for g, a in zip(got, other)):
            raise AssertionError(f"{name} differs from its [B, N, H, D] "
                                 "instance on the same heads")
        log("f32", f"(j) {name}: bit-equal to its [B, N, H, D] instance on "
            f"the same heads; {stats[name]['ms']:.4f} ms against "
            f"{cuda_ms(timed_bnhd[name]):.4f} ms in [B, N, H, D]; {card}")
    return stats


# The f32 explanations of the flagship on the card against the CPU plain
# path ((k) of the f32 phase), by relative Frobenius error: the probe's
# logits, activations, gradients and raw CAM (batch 2), the menu's raw
# gradcam and one chunk of AblationCAM's scores, integrated gradients and
# grad x input (one volume each). The limit is set against the CPU's own
# drift: the same quantities on the CPU with every voxel moved by one ulp
# are held to it too. Read on an H100 80GB HBM3 at 700 W: the card 5.1e-7
# to 2.04e-6 from the CPU, the CPU 2.4e-7 to 1.48e-6 from itself one ulp
# off (the raw CAM the largest of both); the limit stands at about five
# times the larger reading, room for another cuBLAS algorithm on another
# card.
F32_CAM_RTOL = 1e-5


def _f32_explanations(fcfg, ckpt: str, card: str, counters: dict) -> dict:
    """(k) of the f32 phase: Grad-CAM of the f32 flagship on the card
    (get_attention_map, the menu's gradcam and ablationcam at score_batch
    16, integrated gradients at 4 steps, grad x input), every call's
    launches counted exactly (a probe: K1-K3 f32 depth - 1 times, K4 f32
    depth times, K6 f32 once and, under the gradient, K6's backward and
    K9 at f32 once; IG and grad x input: the f32 block kernels through
    every block; no bf16 kernel), the results against the CPU plain path
    within F32_CAM_RTOL, as is the CPU against itself one ulp off. Returns
    the launch counts."""
    from neurovit_tpu_torch.explainability import bcos, cam_methods
    from neurovit_tpu_torch.explainability import gradcam_vit3d as gc
    from neurovit_tpu_torch.explainability import integrated_gradients as ig
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    phase = "f32"
    t0 = time.perf_counter()
    size = fcfg["TRAINING_VIT_INPUT_SIZE"]
    threshold = float(fcfg["GRADCAM_THRESHOLD"])
    cpu = NeuroEncoder(fcfg, device="cpu", seed=SEED)
    load_checkpoint(cpu, ckpt, strict=True)
    _lift_layer_norms(cpu, SEED)
    model = NeuroEncoder(fcfg, device="cuda", seed=SEED)
    model.load_state_dict(cpu.state_dict(), strict=True)
    depth, dim = model.vit_cfg.depth, model.vit_cfg.dim
    rng = np.random.default_rng(SEED + 27)
    vols = _volumes(rng, 2, size)
    ulp = np.nextafter(vols, np.float32(np.inf))
    noise = rng.standard_normal(vols[0].shape).astype(np.float32)
    total = {name: 0 for name in counters}

    def probe_counts(forwards: int, backwards: int) -> dict:
        want = {name: 0 for name in counters}
        want.update({name: (depth - 1) * forwards for name in (
            "flash_attention_f32", "fused_ln_qkv_f32",
            "fused_outproj_residual_f32")})
        want.update(fused_mlp_block_f32=depth * forwards,
                    flash_attention_bhnd_f32=forwards,
                    flash_attention_bhnd_bwd_f32=backwards,
                    fused_mlp_bwd_f32=backwards)
        return want

    def model_counts(forwards: int, backwards: int) -> dict:
        return {name: depth * forwards if name in F32_FORWARD_KERNELS
                else depth * backwards if name in F32_BACKWARD_KERNELS else 0
                for name in counters}

    def counted(what: str, want: dict, fn):
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        _check_counts(f"(k) {what}", got, want)
        for name, n in got.items():
            total[name] += n
        return out

    cams, idx = counted("one get_attention_map of 2 volumes",
                        probe_counts(1, 1),
                        lambda: model.get_attention_map(vols))
    if (cams.shape != (2, size, size, size) or not np.isfinite(cams).all()
            or cams.min() < 0 or cams.max() > 1 + 1e-6):
        raise AssertionError(f"f32 maps: shape {cams.shape}, range "
                             f"[{cams.min()}, {cams.max()}]")
    want_cams, want_idx = cpu.get_attention_map(vols)
    log(phase, f"(k) get_attention_map of 2 volumes: classes "
        f"{idx.tolist()} (cpu {want_idx.tolist()}), final maps within "
        f"{np.abs(cams - want_cams).max():.3e} of the cpu's, "
        f"{(np.abs(cams - want_cams) > 1e-3).mean() * 100:.4f} % of voxels "
        f"off by more than 1e-3 (the percentile threshold moves a voxel "
        f"across it by a rounding)")
    if idx.tolist() != want_idx.tolist():
        raise AssertionError("f32 Grad-CAM classes differ from the cpu's")

    errs, drift = {}, {}

    def hold(what: str, got, want, moved) -> None:
        errs[what] = _rel_err(torch.as_tensor(got), torch.as_tensor(want))
        drift[what] = _rel_err(torch.as_tensor(moved), torch.as_tensor(want))

    x = torch.from_numpy(vols)
    card_p = counted("probe_acts_grads", probe_counts(1, 1),
                     lambda: gc.probe_acts_grads(model, x.cuda()))
    cpu_p = gc.probe_acts_grads(cpu, x)
    ulp_p = gc.probe_acts_grads(cpu, torch.from_numpy(ulp))
    if not torch.equal(card_p[1].cpu(), cpu_p[1]):
        raise AssertionError("f32 probe classes differ from the cpu's")
    for i, what in ((0, "logits"), (2, "probe activations"),
                    (3, "probe gradients")):
        hold(what, card_p[i].cpu(), cpu_p[i], ulp_p[i])
    hold("raw CAM",
         gc.raw_attention_map(model, card_p[2], card_p[3]).cpu(),
         gc.raw_attention_map(cpu, cpu_p[2], cpu_p[3]),
         gc.raw_attention_map(cpu, ulp_p[2], ulp_p[3]))

    # The menu: gradcam (its raw map held, its final map counted), and
    # ablationcam at score_batch 16 on the card, one chunk of its scores
    # held against the CPU's.
    x1 = x[:1]
    raw = counted("menu gradcam, raw", probe_counts(1, 1),
                  lambda: cam_methods._grad_cam_raw(model, x1.cuda(),
                                                    "gradcam", False))
    hold("menu gradcam raw", raw[0].cpu(),
         cam_methods._grad_cam_raw(cpu, x1, "gradcam", False)[0],
         cam_methods._grad_cam_raw(cpu, torch.from_numpy(ulp[:1]), "gradcam",
                                   False)[0])
    cam, _ = counted("menu gradcam", probe_counts(1, 1),
                     lambda: cam_methods.compute_cam(model, vols[0],
                                                     method="gradcam"))
    score_batch = 16
    chunks = -(-dim // score_batch)
    t_abl = time.perf_counter()
    abl, _ = counted(f"menu ablationcam, score_batch {score_batch}",
                     probe_counts(1 + chunks, 0),
                     lambda: cam_methods.compute_cam(
                         model, vols[0], method="ablationcam",
                         score_batch=score_batch))
    t_abl = time.perf_counter() - t_abl
    for what, m in (("gradcam", cam), ("ablationcam", abl)):
        if (m.shape != (size,) * 3 or not np.isfinite(m).all()
                or m.min() < 0 or m.max() > 1 + 1e-6):
            raise AssertionError(f"f32 {what}: shape {m.shape}, range "
                                 f"[{m.min()}, {m.max()}]")

    def chunk_scores(net, xv):
        with torch.inference_mode():
            _, acts = cam_methods._probe_forward(net, xv)
            onehot = torch.eye(dim, device=xv.device)[:4]
            shifts = -acts * onehot[:, None, :]
            return net.probe(xv.expand((4,) + xv.shape[1:]), shifts)[0].cpu()

    hold("ablationcam chunk scores",
         counted("one ablationcam chunk", probe_counts(2, 0),
                 lambda: chunk_scores(model, x1.cuda())),
         chunk_scores(cpu, x1), chunk_scores(cpu, torch.from_numpy(ulp[:1])))

    steps = 4
    attr, cls = counted(f"integrated gradients, {steps} steps",
                        model_counts(steps + 1, steps),
                        lambda: ig.integrated_gradients(
                            model, vols[0], baseline=noise, steps=steps))
    want_attr, want_cls = ig.integrated_gradients(cpu, vols[0],
                                                  baseline=noise, steps=steps)
    ulp_attr, _ = ig.integrated_gradients(cpu, ulp[0], baseline=noise,
                                          steps=steps)
    contrib, bcls = counted("grad x input", model_counts(2, 1),
                            lambda: bcos.explain(model, vols[0]))
    want_contrib, want_bcls = bcos.explain(cpu, vols[0])
    ulp_contrib, _ = bcos.explain(cpu, ulp[0])
    if (cls.tolist() != want_cls.tolist()
            or bcls.tolist() != want_bcls.tolist()):
        raise AssertionError("f32 IG or grad x input classes differ from the "
                             "cpu's")
    hold("integrated gradients", attr, want_attr, ulp_attr)
    hold("grad x input", contrib, want_contrib, ulp_contrib)
    log(phase, "(k) relative Frobenius error, cuda against the cpu: "
        f"{ {k: float(f'{v:.4g}') for k, v in errs.items()} }; the cpu one "
        f"ulp off against itself: "
        f"{ {k: float(f'{v:.4g}') for k, v in drift.items()} } (both held "
        f"to {F32_CAM_RTOL})")
    worst = max(max(errs.values()), max(drift.values()))
    if worst > F32_CAM_RTOL:
        raise AssertionError(f"f32 explanations: {errs}, drift {drift}")
    xb = {b: torch.from_numpy(_volumes(rng, b, size)).cuda() for b in (1, 8)}
    times = {b: cuda_ms(lambda: gc.attention_map(model, xb[b], threshold),
                        warmup=2, runs=10) for b in (1, 8)}
    log(phase, f"(k) f32 Grad-CAM: {times[1]:.3f} ms at batch 1, "
        f"{times[8]:.3f} ms at batch 8 ({8 / times[8] * 1e3:.1f} vol/s); "
        f"ablationcam of one volume ({1 + chunks} probe forwards) "
        f"{t_abl:.2f} s host clock; (k) in {time.perf_counter() - t0:.1f} s; "
        f"{card}")
    del model, cpu, xb
    return total


def _vit_cam_2d_phase(workdir: str, card: str, counters: dict) -> dict:
    """(l) of the f32 phase: the 2D CAM tutorial on the card. The demo ViT
    (f32, depth 2) trained for 300 steps, K1-K4 f32 twice and K5, K7-K9
    f32 twice a step and nothing else; then layercam and scorecam on 8
    held-out squares, holding the JAX tutorial's own bar (at least 7 of 8
    classified right, at least 5 of 8 maps brighter on the square for each
    method), K6 f32 once a probe forward and its backward once a layercam;
    the trained model's probe (logits, activations, gradients, raw
    layercam map) and one train batch's parameter gradients against the
    CPU plain path; the CLI's main() with --steps 200 writing its PNG. Every f32
    block kernel and K6 f32 forward and backward launched. Returns the
    launch counts."""
    import torch.nn.functional as F

    from neurovit_tpu_torch.explainability import vit_cam_2d as v2

    phase = "f32"
    t0 = time.perf_counter()
    total = {name: 0 for name in counters}

    def add() -> dict:
        got = {name: c.launches for name, c in counters.items()}
        for name, n in got.items():
            total[name] += n
        return got

    _reset(counters)
    model = v2.ViT2D(device="cuda")
    depth = model.vit_cfg.depth
    steps = 300
    t_train = time.perf_counter()
    losses = v2.train_demo_model(model, steps=steps, verbose=False).cpu()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t_train
    _check_counts("(l) train_demo_model", add(), {
        name: depth * steps if name in F32_KERNELS else 0
        for name in counters})
    if not torch.isfinite(losses).all():
        raise AssertionError("the 2D demo model's losses are not finite")
    log(phase, f"(l) 2D demo ViT trained for {steps} steps at batch 32 on "
        f"cuda in {t_train:.1f} s host clock: loss {float(losses[0]):.4f} "
        f"-> {float(losses[-1]):.4f}")

    images, labels = v2.make_squares(
        8, generator=torch.Generator().manual_seed(123))
    cpu = v2.ViT2D(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    _reset(counters)
    t_cam = time.perf_counter()
    hits, correct, maps = {}, 0, {}
    for method in ("layercam", "scorecam"):
        hits[method] = 0
        for i in range(8):
            cam, idx = v2.compute_cam_2d(model, images[i], method=method,
                                         threshold=20.0)
            square = images[i] == 1.0
            hits[method] += int(cam[square].mean() > cam[~square].mean())
            if method == "layercam":
                correct += int(idx[0]) == labels[i]
                maps[i] = cam
    t_cam = time.perf_counter() - t_cam
    chunks = -(-model.vit_cfg.dim // 32)
    want = {name: 0 for name in counters}
    want.update({name: 8 * (depth - 1) + 8 * (depth - 1) + 8 * chunks * depth
                 for name in ("flash_attention_f32", "fused_ln_qkv_f32",
                              "fused_outproj_residual_f32")})
    want.update(fused_mlp_block_f32=16 * depth + 8 * chunks * depth,
                flash_attention_bhnd_f32=16, flash_attention_bhnd_bwd_f32=8,
                fused_mlp_bwd_f32=8)
    _check_counts("(l) layercam and scorecam of 8 squares", add(), want)
    log(phase, f"(l) 8 held-out squares: {correct}/8 classified right; "
        f"brighter on the square: layercam {hits['layercam']}/8, scorecam "
        f"{hits['scorecam']}/8 (bar: 7 and 5); 16 CAMs in "
        f"{t_cam:.2f} s host clock")
    if correct < 7 or min(hits.values()) < 5:
        raise AssertionError(f"the 2D tutorial: {correct}/8 classified, "
                             f"localized {hits}")

    # The trained model on the card against the CPU plain path, and the
    # CPU against itself with every pixel one ulp off, by relative
    # Frobenius error as in (k), all held to F32_CAM_RTOL: the probe of 2
    # squares (K6 f32 forward and backward at [2, 4, 197, 16], D padded to
    # 32) and its raw layercam map. Then one train batch of the 8 squares:
    # the loss and every parameter gradient (K5, K7-K9 f32 at dim 64, D
    # 16), the worst parameter held to F32_GRAD_RTOL as in (e), beside the
    # CPU's own one-ulp drift.
    from neurovit_tpu_torch.explainability import cam_methods
    from neurovit_tpu_torch.explainability import gradcam_vit3d as gcam

    x = torch.from_numpy(images)
    ulp = torch.from_numpy(np.nextafter(images, np.float32(np.inf)))
    _reset(counters)
    card_p = gcam.probe_acts_grads(model, x[:2].cuda())
    torch.cuda.synchronize()
    want = {name: 0 for name in counters}
    want.update({name: depth - 1 for name in (
        "flash_attention_f32", "fused_ln_qkv_f32",
        "fused_outproj_residual_f32")})
    want.update(fused_mlp_block_f32=depth, flash_attention_bhnd_f32=1,
                flash_attention_bhnd_bwd_f32=1, fused_mlp_bwd_f32=1)
    _check_counts("(l) probe_acts_grads of 2 squares", add(), want)
    cpu_p = gcam.probe_acts_grads(cpu, x[:2])
    ulp_p = gcam.probe_acts_grads(cpu, ulp[:2])
    if not torch.equal(card_p[1].cpu(), cpu_p[1]):
        raise AssertionError("2D probe classes differ from the cpu's")

    def layercam(p):
        return cam_methods._token_cam("layercam", p[2][:, 1:], p[3][:, 1:])

    errs, drift = {}, {}
    for what, get in (("logits", lambda p: p[0]),
                      ("probe activations", lambda p: p[2]),
                      ("probe gradients", lambda p: p[3]),
                      ("raw layercam", layercam)):
        want_v = get(cpu_p)
        errs[what] = _rel_err(get(card_p), want_v)
        drift[what] = _rel_err(get(ulp_p), want_v)
    cam_diff = 0.0
    for i in (0, 1):
        cam, idx = v2.compute_cam_2d(cpu, images[i], method="layercam",
                                     threshold=20.0)
        cam_diff = max(cam_diff, float(np.abs(cam - maps[i]).max()))

    def batch_grads(net, xv):
        net.zero_grad(set_to_none=True)
        loss = F.cross_entropy(net(xv), torch.from_numpy(labels).to(
            xv.device))
        loss.backward()
        return float(loss.detach()), {name: p.grad.float().cpu()
                                      for name, p in net.named_parameters()}

    _reset(counters)
    loss_c, grads_c = batch_grads(model, x.cuda())
    torch.cuda.synchronize()
    _check_counts("(l) one train batch's gradient", add(), {
        name: depth if name in F32_KERNELS else 0 for name in counters})
    loss_p, grads_p = batch_grads(cpu, x)
    loss_u, grads_u = batch_grads(cpu, ulp)
    gerrs = grad_errs(grads_c, grads_p)
    gdrift = grad_errs(grads_u, grads_p)
    log(phase, "(l) the trained 2D model, relative Frobenius error, cuda "
        f"against the cpu: { {k: float(f'{v:.4g}') for k, v in errs.items()} }"
        f"; the cpu one ulp off against itself: "
        f"{ {k: float(f'{v:.4g}') for k, v in drift.items()} } (both held "
        f"to {F32_CAM_RTOL}); final layercam maps of 2 squares within "
        f"{cam_diff:.3e} (the percentile threshold moves a pixel across it "
        f"by a rounding)")
    log(phase, f"(l) one train batch of 8 squares: loss cuda {loss_c:.7f} vs "
        f"cpu {loss_p:.7f}; {err_text(gerrs)} (worst held to "
        f"{F32_GRAD_RTOL}); the cpu one ulp off: {err_text(gdrift)}")
    if max(max(errs.values()), max(drift.values())) > F32_CAM_RTOL:
        raise AssertionError(f"the 2D probe: {errs}, drift {drift}")
    if (abs(loss_c - loss_p) > F32_TOL * (1 + abs(loss_p))
            or max(gerrs.values()) > F32_GRAD_RTOL):
        raise AssertionError(f"the 2D gradients differ from the cpu: loss "
                             f"{loss_c} vs {loss_p}, {err_text(gerrs)}")
    model.zero_grad(set_to_none=True)

    out_dir = os.path.join(workdir, "cam2d")
    _reset(counters)
    text = io.StringIO()
    t_cli = time.perf_counter()
    with contextlib.redirect_stdout(text):
        png = v2.main(["--method", "layercam", "--steps", "200",
                       "--output-dir", out_dir])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t_cli
    cli = add()
    with open(png, "rb") as f:
        head = f.read(8)
    if head != b"\x89PNG\r\n\x1a\n" or "Saved" not in text.getvalue():
        raise AssertionError(f"the 2D tutorial's CLI wrote no PNG at {png}")
    for line in text.getvalue().splitlines()[-3:]:
        log(phase, f"(l) vit_cam_2d CLI: {line}")
    log(phase, f"(l) the CLI with --steps 200 in {t_cli:.1f} s host clock: "
        f"{os.path.getsize(png)} bytes of PNG; launches "
        f"{ {name: n for name, n in cli.items() if n} }")
    unlaunched = [name for name in F32_KERNELS + F32_GRADCAM_KERNELS
                  if not total[name]]
    if unlaunched or any(total[name] for name in counters
                         if name not in F32_KERNELS + F32_GRADCAM_KERNELS):
        raise AssertionError(f"(l) launched {total}")
    log(phase, f"(l) in {time.perf_counter() - t0:.1f} s; launches "
        f"{ {name: n for name, n in total.items() if n} }; {card}")
    return total


def f32_phase(config, ckpt: str, workdir: str, card: str,
              counters: dict) -> tuple:
    """Phase 18 (see the module docstring): (a) the f32 forwards, (b) f32
    serving of the flagship, (c) the f32 4D step at config4D's shape, (d)
    the f32 backwards, (e) the flagship's f32 gradients against the CPU,
    (f) the f32 train runs of the flagship and the smoke model, (g) the
    f32 int8 kernels, (h) f32 int8 serving, (i) the f32 4D step on the int8
    encoder, (j) K6 and its backward at f32, (k) the f32 flagship's
    explanations against the CPU, (l) the 2D CAM tutorial. Returns (the
    kernels' stats, the launch counts of (b), (c), (f), (h), (i), (k) and
    (l))."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.training import Trainer
    from neurovit_tpu_torch.training.checkpoint import load_checkpoint

    phase = "f32"
    t_phase = time.perf_counter()
    stats = _f32_kernel_checks(card)
    torch.cuda.empty_cache()

    # (b) f32 serving: the seed-42 checkpoint through Predictor and HTTP.
    fcfg = dict(config, TRAINING_PRECISION="f32")
    size = fcfg["TRAINING_VIT_INPUT_SIZE"]
    rng = np.random.default_rng(SEED + 23)
    predictor = Predictor.from_checkpoint(fcfg, ckpt, batch_size=32,
                                          device="cuda")
    model = predictor.model
    depth = model.vit_cfg.depth
    forwards = _count_forwards(model)
    vols = _volumes(rng, 3, size)
    _reset(counters)
    predictor.warmup()
    _, probs = predictor(vols)
    http_phase(predictor, rng, workdir, n_files=1, concurrent=False)
    torch.cuda.synchronize()
    serving = {name: fn.launches for name, fn in counters.items()}
    log(phase, f"(b) f32 serving: warmup of buckets "
        f"{predictor.bucket_sizes}, 3 volumes, one POST: {forwards[0]} "
        f"forward calls x depth {depth}; launches {serving}")
    _check_counts("f32 serving", serving, _want(F32_FORWARD_KERNELS,
                                                depth * forwards[0],
                                                counters))
    cpu = NeuroEncoder(fcfg, device="cpu", seed=SEED + 5).eval()
    load_checkpoint(cpu, ckpt, strict=True)
    with torch.inference_mode():
        want = cpu(torch.from_numpy(vols))
        got = model(torch.from_numpy(vols).cuda()).cpu()
    diff = float((got - want).abs().max())
    pdiff = float(np.abs(probs - torch.softmax(want, -1).numpy()).max())
    log(phase, f"(b) f32 logits of 3 volumes, cuda {got.tolist()} vs cpu "
        f"{want.tolist()}: max diff {diff:.3e}, Predictor's probabilities "
        f"{pdiff:.3e} (tol {F32_LOGIT_ATOL})")
    if not torch.isfinite(got).all() or max(diff, pdiff) > F32_LOGIT_ATOL:
        raise AssertionError(f"f32 logits differ from the cpu by {diff}")
    del cpu
    x32 = torch.from_numpy(_volumes(rng, 32, size)).cuda()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x32), warmup=2, runs=5)
        log(phase, f"(b) f32 forward at batch 32: {ms:.3f} ms, "
            f"{32 / ms * 1e3:.1f} vol/s, "
            f"{89.4 * 32 / ms:.1f} TFLOP/s at 89.4 GFLOP a volume; {card}")
        profile_split(phase, "f32 forward at batch 32", lambda: model(x32),
                      ms)
    del predictor, model, x32
    torch.cuda.empty_cache()

    # (c) The f32 4D step at B 2 x T 140: Trainer.run() of one epoch (two
    # steps, one update), then the step and the encoder timed.
    cfg = _fourd_config(workdir, TRAINING_PRECISION="f32", TRAINING_EPOCHS=1,
                        GLOBAL_OUTPUT_DIR=os.path.join(workdir, "runs4d_f32"))
    depth4 = cfg["MODEL_VIT_DEPTH"]
    size4 = cfg["TRAINING_VIT_INPUT_SIZE"]
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    trainer = Trainer(cfg, model, _SeededSequences(4, size4, SEQ_T, SEED,
                                                   "train4d"),
                      _SeededSequences(2, size4, SEQ_T, SEED + 1, "val4d"))
    enc_forwards = _encoder_forwards(model)
    losses, fourd, text = _run_trainer(trainer, counters)
    for line in text.splitlines()[-3:]:
        log(phase, "(c) " + line.expandtabs(1))
    log(phase, f"(c) f32 4D run: losses {losses}; {enc_forwards[0]} encoder "
        f"forwards x depth {depth4}; launches {fourd}")
    _check_counts("the f32 4D run", fourd,
                  _want(F32_FORWARD_KERNELS, depth4 * enc_forwards[0],
                        counters))
    batch, _, _ = next(trainer._device_prefetch(trainer.val_dataloader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_step(batch), 1, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    enc_ms = cuda_ms(lambda: model.encode_sequence(batch["volume"]), 1, 3)
    vols4 = batch["volume"].shape[0] * batch["volume"].shape[-1]
    log(phase, f"(c) f32 4D train step at B 2 x T {SEQ_T} ({vols4} "
        f"volumes): {step_ms:.3f} ms ({vols4 / step_ms * 1e3:.1f} vol/s), "
        f"the encoder {enc_ms:.3f} ms = {100 * enc_ms / step_ms:.1f} % of "
        f"it, {89.4 * vols4 / enc_ms:.1f} TFLOP/s; peak memory {peak:.2f} "
        f"GiB; {card}")
    cpu = NeuroEncoder(cfg, device="cpu", seed=SEED + 2)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    _fold_against_cpu(model, cpu, batch["volume"], phase=phase, edge=1,
                      atol=F32_LOGIT_ATOL, rtol=F32_LOGIT_ATOL)
    del trainer, model, cpu, batch
    torch.cuda.empty_cache()

    # (d) The f32 backwards against their plain versions.
    stats.update(_f32_bwd_kernel_checks(card))
    torch.cuda.empty_cache()

    # (e) The flagship's loss and parameter gradients at f32, card against
    # the CPU plain path, batch 2, dropout 0.1.
    losses, grads = {}, {}
    for dev in ("cuda", "cpu"):
        losses[dev], grads[dev] = param_grads(fcfg, dev, phase)
    errs = grad_errs(grads["cuda"], grads["cpu"])
    log(phase, f"(e) f32 loss cuda {losses['cuda']:.7f} vs cpu "
        f"{losses['cpu']:.7f}; {err_text(errs)} (worst held to "
        f"{F32_GRAD_RTOL})")
    if abs(losses["cuda"] - losses["cpu"]) > F32_TOL * (
            1 + abs(losses["cpu"])) or max(errs.values()) > F32_GRAD_RTOL:
        raise AssertionError(f"f32 loss or gradients differ from the cpu: "
                             f"{losses}, {err_text(errs)}")
    del grads
    torch.cuda.empty_cache()

    # (f) Trainer.run() of the flagship at f32 (two steps at batch 32 and
    # a validation batch), then the step timed at batch 32; the verify
    # recipe's smoke model at f32 through the CLI.
    cfg = _train_config(config, workdir, TRAINING_PRECISION="f32",
                        GLOBAL_OUTPUT_DIR=os.path.join(workdir, "runs_f32"))
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    trainer = Trainer(cfg, model,
                      _SeededVolumes(64, size, SEED + 6, "train_f32"),
                      _SeededVolumes(32, size, SEED + 7, "val_f32"))
    forwards = _count_forwards(model)
    losses, train, text = _run_trainer(trainer, counters)
    for line in text.splitlines()[-3:]:
        log(phase, "(f) " + line.expandtabs(1))
    log(phase, f"(f) f32 train run: losses {losses}; {forwards[0]} forwards "
        f"and {len(losses)} backwards x depth {depth}; launches {train}")
    _check_counts("the f32 train run", train, {
        name: depth * forwards[0] if name in F32_FORWARD_KERNELS
        else depth * len(losses) if name in F32_BACKWARD_KERNELS else 0
        for name in counters})
    batch, zyx, _ = next(trainer._device_prefetch(trainer.val_dataloader))
    step_ms, all_ms, peak = _timed_steps(trainer, batch, zyx, warmup=2)
    vols = batch["volume"].shape[0]
    log(phase, f"(f) f32 train step at batch {vols}: {step_ms:.3f} ms median "
        f"of 5 (all {all_ms}), {vols / step_ms * 1e3:.1f} vol/s, "
        f"{TRAIN_GFLOP_PER_VOL * vols / step_ms:.1f} TFLOP/s "
        f"({TRAIN_GFLOP_PER_VOL:.1f} GFLOP/vol), peak memory {peak:.2f} GiB; "
        f"{card}")
    profile_split(phase, f"f32 train step at batch {vols}",
                  lambda: trainer.train_step(batch, zyx), step_ms)
    del trainer, model, batch
    torch.cuda.empty_cache()
    smoke = smoke_cli(config, workdir, counters, "f32", phase)
    f32_counts = [smoke[name] for name in F32_KERNELS]
    # Each block's backward launches K5, K7, K8 and K9 at f32 once and the
    # backwards' weight pre-pass four times (Wout, Wqkv, W2, W1).
    backward = {smoke[name] for name in F32_BACKWARD_KERNELS
                if name != "fused_outproj_bwd_wsplit_f32"}
    if (0 in f32_counts or len(backward) != 1 or min(backward) % 2
            or smoke["fused_outproj_bwd_wsplit_f32"] != 4 * min(backward)
            or any(n for name, n in smoke.items() if name not in F32_KERNELS)):
        raise AssertionError(f"the f32 smoke CLI run launched {smoke}")
    torch.cuda.empty_cache()

    # (g)-(i): K10-K13 at f32, then int8 serving of the f32 flagship and
    # the f32 4D step on the int8 encoder.
    t_int8 = time.perf_counter()
    stats.update(_int8_f32_kernel_checks(card))
    torch.cuda.empty_cache()
    int8_serving = _int8_f32_serving(fcfg, ckpt, workdir, card, counters)
    int8_fourd = _int8_f32_fourd(workdir, card, counters)
    log(phase, f"(g)-(i) in {time.perf_counter() - t_int8:.1f} s")
    torch.cuda.empty_cache()

    # (j)-(l): K6 and its backward at f32, the f32 flagship's explanations
    # against the CPU, the 2D CAM tutorial.
    t_cam = time.perf_counter()
    stats.update(_k6_f32_kernel_checks(card))
    torch.cuda.empty_cache()
    explain = _f32_explanations(fcfg, ckpt, card, counters)
    torch.cuda.empty_cache()
    cam2d = _vit_cam_2d_phase(workdir, card, counters)
    log(phase, f"(j)-(l) in {time.perf_counter() - t_cam:.1f} s; done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return stats, {name: serving[name] + fourd[name] + train[name]
                   + smoke[name] + int8_serving[name] + int8_fourd[name]
                   + explain[name] + cam2d[name] for name in counters}


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


# ---------------------------------------------------------------------------
# 20. dp: data parallelism
# ---------------------------------------------------------------------------

# A data-parallel step against one process on the same global batch: the
# losses (f32 sums of the same per-row values taken in another order). The
# ResNet's at the JAX test's bound (tests/test_sharding.py:84): its global
# BatchNorm sums each channel over the ranks' halves in another order, and
# twenty BatchNorms move the loss by tens of f32 ulps (1.7e-6 relative on
# the CPU rehearsal at depth 10).
DP_LOSS_RTOL = 1e-6
DP_BN_LOSS_RTOL = 1e-5
# Gradients, relative Frobenius error per parameter, a parameter's norm
# floored at this share of the model's largest gradient norm (the rule of
# tests/test_torch_parallel_ranks.py: the 4D temporal layer's gradients are
# 1e-10 to 1e-4 of the projection's, f32 noise of the same sums).
DP_GRAD_FLOOR = 1e-3
# (b)'s cases: the flagship bf16 at global batch 16, f32 at 8, the
# ResNet-18 at 4 (f32: its bf16 gradients move by tens of percent with one
# rounding, phase 16), config4D's B 2 x T 140 on the int8 encoder.
DP_CASES = {"vit_bf16": 16, "vit_f32": 8, "resnet_f32": 4, "fourd_int8": 2}
DP_WORLD = 2
# (a)'s CLI runs: 24 train volumes at batch 8.
DP_STEPS = 3
# torchrun's and the launcher's variables, kept out of the runs' children.
_LAUNCH_ENVS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "GROUP_RANK", "ROLE_RANK", "MASTER_ADDR", "MASTER_PORT",
                "TORCHELASTIC_RUN_ID")


def _repo_env() -> dict:
    """This environment for a child run from the repository: its root on
    PYTHONPATH, no launcher's variables."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENVS}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    return env


def _dp_cli_run(config, workdir: str, name: str, launcher: list):
    """Start ``python -m neurovit_tpu_torch.main`` (after ``launcher``) on
    the flagship, bf16, over 30 seeded synthetic cube volumes (24 train at
    batch 8: DP_STEPS steps, 6 validation), in a directory of its own.
    Returns (the process, its directory, its output file)."""
    import yaml
    root = os.path.join(workdir, "dp", name)
    os.makedirs(root)
    cfg = {**config, "DATASET_NAME": "gradcam", "DATASET_GENERATE": True,
           "GRADCAM_NUM_SAMPLES": 30,
           "GRADCAM_TRAIN_PATH": os.path.join(root, "gradcam_train.pkl"),
           "GRADCAM_VAL_PATH": os.path.join(root, "gradcam_val.pkl"),
           "TRAINING_BATCH_SIZE": 8, "TRAINING_EPOCHS": 1,
           "TRAINING_NUM_WORKERS": 4, "TRAINING_PRECISION": "bf16",
           "WANDB_ENABLED": False,
           "GLOBAL_OUTPUT_DIR": os.path.join(root, "runs")}
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = open(os.path.join(root, "out.txt"), "w")
    cmd = [sys.executable, *launcher, "-m", "neurovit_tpu_torch.main",
           f"dp_{name}", "--wandb", "false", "--config", path]
    proc = subprocess.Popen(cmd, cwd=root, env=_repo_env(), stdout=out,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return proc, root, out


def _stop(proc) -> None:
    """Kill ``proc`` and every process of its session (torchrun's worker
    among them), if it still runs."""
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _finish(proc, out, what: str, timeout: float = 600) -> str:
    """Wait for ``proc``; its output, which must end in exit code 0."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        _stop(proc)
        out.close()
    text = open(out.name).read()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}: {text[-4000:]}")
    return text


def _dp_train_lines(text: str) -> list:
    """The run's train and validation lines without their durations."""
    import re
    return [re.sub(r"duration: [0-9.]+s", "", line) for line in
            text.splitlines()
            if line.startswith(("epoch ", "[VALIDATION]"))]


TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=1"]


def _dp_entry_point(config, workdir: str, runs: dict, card: str) -> None:
    """(a): the CLI under torchrun at world 1 (NCCL) against the CLI with
    no process group, both started at the phase's start: their train and
    validation lines and their train states after DP_STEPS steps bit for
    bit; then the step at batch 128 through the NCCL path beside the
    plain step (scripts/torch_dp_step_times.py, in turns)."""
    import glob
    phase = "dp"
    texts, states = {}, {}
    for name, (proc, root, out) in runs.items():
        texts[name] = _finish(proc, out, f"the {name} CLI run")
        files = glob.glob(os.path.join(root, "runs", "*", "model-e0"))
        if len(files) != 1:
            raise AssertionError(f"{name}: train state not written: {files}")
        states[name] = torch.load(files[0], map_location="cpu",
                                  weights_only=True)
    for want in ("Distributed runtime: rank 0/1 on cuda:0",
                 "Running on mesh: {'data': 1, 'model': 1, 'pipe': 1} "
                 "(nccl)"):
        if want not in texts["nccl"]:
            raise AssertionError(f"torchrun's run did not print {want!r}")
    if "(one process)" not in texts["plain"]:
        raise AssertionError("the plain run did not run in one process")
    lines = {name: _dp_train_lines(text) for name, text in texts.items()}
    if not lines["plain"] or lines["plain"] != lines["nccl"]:
        raise AssertionError(f"train lines differ: {lines}")
    _equal_states(states["nccl"], states["plain"], "model-e0")
    steps = states["plain"]["optimizer"]["steps"]
    if steps != DP_STEPS:
        raise AssertionError(f"{steps} optimizer steps, expected {DP_STEPS}")
    for line in lines["nccl"]:
        log(phase, f"(a) torchrun, NCCL, world 1: {line.expandtabs(1)}")
    log(phase, f"(a) torchrun -m neurovit_tpu_torch.main at world 1 (NCCL): "
        f"{steps} steps of the flagship, bf16, dropout "
        f"{config['TRAINING_DROPOUT']}: train and validation lines and the "
        "train state (weights, AdamW moments, seed stream) bit-equal to the "
        "run with no process group")

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, *TORCHRUN,
         os.path.join(here, "scripts", "torch_dp_step_times.py"),
         "--batch", "128"], cwd=workdir, env=_repo_env(),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"torch_dp_step_times exited {proc.returncode}:"
                             f" {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    for line in proc.stdout.strip().splitlines()[:-2]:
        log(phase, f"(a) {line}")
    times = json.loads(proc.stdout.strip().splitlines()[-1])
    log(phase, f"(a) train step at batch 128, flagship bf16: plain "
        f"{times['plain_ms']} ms, through the NCCL path {times['dp_ms']} ms "
        f"(medians of 5, turns plain, dp, dp, plain), peak "
        f"{times['peak_gib']} GiB; {times['card']}")


def _dp_case(name: str, workdir: str, precision=None, cases=None,
             **extra):
    """(config, train dataset, global host batch) of a case of (b) (of
    ``cases``, default DP_CASES, with the config keys ``extra``), its
    TRAINING_PRECISION ``precision`` when given."""
    from neurovit_tpu_torch.config import load_config
    config = load_config()
    out = os.path.join(workdir, "dp", "cases")
    b = (cases or DP_CASES)[name]
    common = {"TRAINING_DROPOUT": 0.0, "TRAINING_LEARNING_RATE": 1e-4,
              "TRAINING_BATCH_SIZE": b, "TRAINING_NUM_WORKERS": 1,
              "WANDB_ENABLED": False, "GLOBAL_OUTPUT_DIR": out, **extra}
    rng = np.random.default_rng(SEED + 20)
    if name == "fourd_int8":
        cfg = _fourd_config(workdir, **common, MODEL_TEMPORAL_DROPOUT=0.0,
                            TRAINING_ACCUMULATION_STEP=1,
                            TRAINING_4D_ENCODER_QUANT="int8")
        size = cfg["TRAINING_VIT_INPUT_SIZE"]
        data = _SeededSequences(b, size, SEQ_T, SEED + 21, "dp")
        vols = np.stack([data.sample(i)["volume"] for i in range(b)])
    else:
        extra = ({"MODEL_VOLUME_ENCODER": "resnet", "MODEL_RESNET_DEPTH": 18}
                 if name.startswith("resnet") else {})
        cfg = {**config, **common, **extra,
               "TRAINING_PRECISION": name.rsplit("_", 1)[1]}
        size = cfg["TRAINING_VIT_INPUT_SIZE"]
        data = _SeededVolumes(b, size, SEED + 21, "dp")
        vols = rng.standard_normal((b,) + (size,) * 3, dtype=np.float32)
    batch = {"volume": vols, "label": np.arange(b) % 2,
             "valid": np.ones(b, np.bool_)}
    if precision is not None:
        cfg = dict(cfg, TRAINING_PRECISION=precision)
    return cfg, data, batch


def _digest(tensors: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for name, value in tensors.items():
        h.update(name.encode())
        h.update(value.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_run_case(name: str, workdir: str, counters: dict, mesh=None,
                 keep: bool = True, precision=None, cases=None,
                 keep_state: bool = False, **extra) -> dict:
    """One train step of case ``name`` on this process's rows, the launch
    counts set to 0 just before it and read just after: the loss and count
    it reports, the reduced gradients (``keep``) and their digest, the
    state's digest (its BatchNorm running stats kept), the launches. A
    tensor-parallel rank's gradients and state are gathered whole."""
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.parallel import sharding, tensor_parallel
    from neurovit_tpu_torch.training import Trainer

    cfg, data, batch = _dp_case(name, workdir, precision, cases, **extra)
    model = NeuroEncoder(cfg, device="cuda", seed=SEED)
    trainer = Trainer(cfg, model, data, data, mesh=mesh)
    if trainer._shard_rows:
        batch = sharding.local_rows(batch, trainer.mesh)
    dbatch = {"volume": torch.from_numpy(batch["volume"]).cuda(),
              "label": torch.from_numpy(batch["label"]).long().cuda(),
              "valid": torch.from_numpy(batch["valid"]).cuda()}
    grads, encoded = {}, []
    if trainer._q8_encoder is not None:
        trainer._q8_encoder.register_forward_hook(
            lambda _m, args, _out: encoded.append(int(args[0].shape[0])))
    names = {id(p): n for n, p in model.named_parameters()}
    reduce = trainer.optimizer.before_update

    def capture(params):
        if reduce is not None:
            reduce(params)
        grads.update({names[id(p)]: p.grad.detach().float().clone()
                      for p in params})

    trainer.optimizer.before_update = capture
    _reset(counters)
    m = trainer.train_step(dbatch)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    state = trainer._whole_state()
    if trainer._tp:
        grads = {k: tensor_parallel.gather(v, k, trainer.mesh)
                 for k, v in grads.items()}
    out = {"loss": float(m["loss"]), "count": int(m["count"]),
           "rows": int(dbatch["valid"].shape[0]), "encoded": encoded,
           "grad_digest": _digest(grads), "state_digest": _digest(state),
           "stats": {k: v.cpu() for k, v in state.items()
                     if "running_" in k},
           "launches": launches}
    if keep:
        out["grads"] = {k: v.cpu() for k, v in grads.items()}
    if keep_state:
        out["state"] = {k: v.cpu() for k, v in state.items()}
    del trainer, model
    return out


def _dp_rank(rank: int, world: int, workdir: str) -> None:
    """(b)'s rank: a gloo group by a file:// rendezvous, adopted by the
    port, every case run on this rank's rows on cuda:0, the results saved
    for the parent (rank 0's gradients only: the reduced gradients are the
    same on every rank, which their digests show)."""
    import torch.distributed as dist
    from neurovit_tpu_torch.parallel import create_mesh, distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        if not distributed.maybe_initialize({}, torch.device("cuda", 0)):
            raise AssertionError("the port did not adopt the group")
        if create_mesh({}).data != world:
            raise AssertionError("the mesh is not the group")
        counters = kernel_counters()
        results = {name: _dp_run_case(name, workdir, counters,
                                      keep=rank == 0)
                   for name in DP_CASES}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_grad_errs(got: dict, want: dict) -> dict:
    floor = DP_GRAD_FLOOR * max(float(w.norm()) for w in want.values())
    return {k: float((got[k] - w).norm()) / max(float(w.norm()), floor)
            for k, w in want.items()}


def _dp_hold_bf16(name: str, got: dict, want: dict, truth: dict,
                  label: str = "data-parallel") -> str:
    """The bf16 flagship's reduced gradients against the one-process f32
    gradients of the same weights and batch: no farther than
    BF16_GRAD_RATIO times the one-process bf16 gradients' error plus
    GRAD_RTOL, in the worst and the median parameter (the ResNet's rule,
    phase 16: a gradient summed over the batch is rounded to bf16 once a
    rank here and once in one process)."""
    errs = {label: _dp_grad_errs(got, truth),
            "one process": _dp_grad_errs(want, truth)}
    for stat in (max, lambda v: float(np.median(v))):
        dp, one = (stat(list(e.values())) for e in errs.values())
        if dp > BF16_GRAD_RATIO * one + GRAD_RTOL:
            raise AssertionError(
                f"{name}: bf16 gradients {dp:.3e} from the f32 gradients, "
                f"one process's {one:.3e} (held to {BF16_GRAD_RATIO} x + "
                f"{GRAD_RTOL})")
    return "; against the f32 gradients: " + ", ".join(
        f"{k} {err_text(e)}" for k, e in errs.items()) + (
        f" (held to {BF16_GRAD_RATIO} x one process's + {GRAD_RTOL}, worst "
        "and median)")


def _dp_hold_ranks(ranks: list, single: dict, truth: dict,
                   card: str) -> dict:
    """(b): every rank against one process, and the ranks against each
    other; ``truth`` holds one-process f32 gradients of the bf16 cases.
    Returns rank 0's launches, summed over the cases."""
    phase = "dp"
    total = {}
    for name, b in DP_CASES.items():
        want = single[name]
        # The ViT's f32 bound (phase 18); the ResNet's f32 gradients are
        # held to GRAD_RTOL, as in phase 16: cuDNN picks its convolutions'
        # algorithms by the batch, and a BatchNorm bias's gradient, a sum
        # that nearly cancels, moves by 4e-3 of its norm with them.
        bound = F32_GRAD_RTOL if name == "vit_f32" else GRAD_RTOL
        loss_rtol = DP_BN_LOSS_RTOL if want["stats"] else DP_LOSS_RTOL
        for r, res in enumerate(ranks):
            got = res[name]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            if rel > loss_rtol or got["count"] != want["count"]:
                raise AssertionError(
                    f"{name} rank {r}: loss {got['loss']!r} count "
                    f"{got['count']} against one process's {want['loss']!r}"
                    f" {want['count']} (relative {rel:.3e}, held to "
                    f"{loss_rtol})")
            if got["launches"] != want["launches"]:
                raise AssertionError(f"{name} rank {r} launched "
                                     f"{got['launches']}, one process "
                                     f"{want['launches']}")
            for key in ("state_digest", "grad_digest"):
                if got[key] != ranks[0][name][key]:
                    raise AssertionError(f"{name}: rank {r}'s {key} differs "
                                         "from rank 0's")
        path = [n for n, c in want["launches"].items() if c]
        if not path:
            raise AssertionError(f"{name}: the step launched no kernel")
        errs = _dp_grad_errs(ranks[0][name]["grads"], want["grads"])
        held = ""
        if name in truth:
            held = _dp_hold_bf16(name, ranks[0][name]["grads"],
                                 want["grads"], truth[name])
        elif max(errs.values()) > bound:
            raise AssertionError(f"{name}: {err_text(errs)} above {bound}")
        stream = ""
        if want["encoded"]:
            stream = (f", the B·T stream of {want['encoded'][0]} volumes "
                      f"split {[res[name]['encoded'][0] for res in ranks]} "
                      "over the ranks")
            if [res[name]["encoded"][0] for res in ranks] != [
                    want["encoded"][0] // len(ranks)] * len(ranks):
                raise AssertionError(f"{name}: the stream was not split")
        log(phase, f"(b) {name}: global batch {b}, {ranks[0][name]['rows']} "
            f"rows a rank{stream}; loss {ranks[0][name]['loss']!r} against "
            f"one process's {want['loss']!r} (held to {loss_rtol} rel); "
            f"against one process: {err_text(errs)} (floor {DP_GRAD_FLOOR} "
            f"of the largest{'' if held else f'; held to {bound}'}){held}; "
            f"parameters after the update and reduced "
            f"gradients bit-equal on the {len(ranks)} ranks; each rank "
            f"launched {path} as one process does")
        for key, value in want["stats"].items():
            gap = float(((ranks[0][name]["stats"][key].float() - value.float())
                         .abs() / (1 + value.float().abs())).max())
            if gap > F32_TOL:
                raise AssertionError(f"{name}: {key} {gap:.3e} from one "
                                     "process's")
        if want["stats"]:
            log(phase, f"(b) {name}: {len(want['stats'])} BatchNorm running "
                "statistics from the global batch, bit-equal on the ranks, "
                f"within {F32_TOL} (1 + |x|) of one process's")
        for n, c in ranks[0][name]["launches"].items():
            total[n] = total.get(n, 0) + c
    return total


def _dp_serving(ckpt: str, counters: dict) -> dict:
    """(c): the flagship served at batch 32 on two replicas on cuda:0 (the
    Predictor that --mesh builds, one replica a card), bf16 and int8,
    against the one-replica Predictor, 37 volumes (a chunk of 32, split
    16 / 16, and the 5 in the bucket of 8, split 4 / 4). Returns the
    two-replica runs' launches."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.serving import Predictor
    phase = "dp"
    config = load_config()
    vols = _volumes(np.random.default_rng(SEED + 22), 37,
                    config["TRAINING_VIT_INPUT_SIZE"])
    depth = config["MODEL_VIT_DEPTH"]
    total = {name: 0 for name in counters}
    for quant in (None, "int8"):
        one = Predictor.from_checkpoint(config, ckpt, batch_size=32,
                                        device="cuda", quant=quant)
        two = Predictor.from_checkpoint(config, ckpt, batch_size=32,
                                        quant=quant,
                                        devices=["cuda:0", "cuda:0"])
        _, want = one(vols)
        forwards = [_count_forwards(r) for r in two.replicas]
        _reset(counters)
        labels, probs = two(vols)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        n_fwd = [f[0] for f in forwards]
        kernels = (["int8_ln_qkv", "int8_outproj_residual", "int8_mlp_block",
                    "int8_flash_attention"] if quant else BF16_BLOCK_KERNELS)
        _check_counts(f"two-replica {quant or 'bf16'} serving", launches,
                      _want(kernels, depth * sum(n_fwd), counters))
        for n, c in launches.items():
            total[n] += c
        gap = float(np.abs(probs - want).max())
        if not np.isfinite(probs).all() or gap > PROB_ATOL:
            raise AssertionError(f"two replicas {quant or 'bf16'}: {gap} "
                                 f"from one replica's probabilities")
        if not (labels == probs.argmax(axis=1)).all():
            raise AssertionError("labels are not the probabilities' argmax")
        log(phase, f"(c) {quant or 'bf16'}: two replicas on cuda:0, buckets "
            f"{two.bucket_sizes}, {n_fwd} forwards of the replicas: "
            f"{'bit-equal to' if gap == 0 else f'{gap:.3e} from'} the "
            f"one-replica Predictor's probabilities on all 37 rows (held to "
            f"{PROB_ATOL}); launches {kernels} {depth} x {sum(n_fwd)}")
        del one, two
        torch.cuda.empty_cache()
    return total


def dp_phase(config, ckpt: str, workdir: str, card: str,
             counters: dict) -> dict:
    """Data parallelism: (a) the CLI under torchrun at world 1 over NCCL
    against the CLI without a group, and the step's time at batch 128;
    (b) two ranks on the one card over gloo against one process; (c)
    two-replica serving. The two CLI runs and the two ranks run while this
    process computes (b)'s one-process steps and (c); the timing runs
    alone after. Returns the launch counts of (b)'s rank 0 and of (c)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    runs = {name: _dp_cli_run(config, workdir, name, launcher)
            for name, launcher in (("plain", []), ("nccl", TORCHRUN))}
    rdv = os.path.join(workdir, "dp", "ranks")
    os.makedirs(rdv)
    ctx = mp.start_processes(_dp_rank, args=(DP_WORLD, rdv),
                             nprocs=DP_WORLD, join=False,
                             start_method="spawn")
    try:
        return _dp_phase_body(config, ckpt, workdir, card, counters, runs,
                              ctx, rdv, t0)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        for proc, _, out in runs.values():
            _stop(proc)
            out.close()


def _dp_phase_body(config, ckpt: str, workdir: str, card: str,
                   counters: dict, runs: dict, ctx, rdv: str,
                   t0: float) -> dict:
    """dp_phase's work once its children are started (see there)."""
    phase = "dp"
    single = {name: _dp_run_case(name, rdv, counters) for name in DP_CASES}
    truth = {"vit_bf16": _dp_run_case("vit_bf16", rdv, counters,
                                      precision="f32")["grads"]}
    torch.cuda.empty_cache()
    total = _dp_serving(ckpt, counters)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            raise AssertionError("(b)'s ranks did not finish in 600 s")
    ranks = [torch.load(os.path.join(rdv, f"rank{r}.pt"), weights_only=True)
             for r in range(DP_WORLD)]
    for name, n in _dp_hold_ranks(ranks, single, truth, card).items():
        total[name] += n
    del ranks, single, truth
    _dp_entry_point(config, workdir, runs, card)
    log(phase, f"done in {time.perf_counter() - t0:.1f} s; launches "
        f"{ {n: c for n, c in total.items() if c} }; {card}")
    return total


# ---------------------------------------------------------------------------
# Tensor parallelism (the tp phase)
# ---------------------------------------------------------------------------

# (b)'s cases: the flagship bf16 and f32 at global batch 8, config4D's B 2
# x T 140 on the int8 encoder; two ranks at tp 2, dp 1.
TP_CASES = {"vit_bf16": 8, "vit_f32": 8, "fourd_int8": 2}
TP_WORLD = 2
# JAX's bounds of a dp x tp step against one device (tests/test_sharding.py
# :83-89): the loss within 1e-5 relative, each updated parameter within
# 2e-4 relative + 1e-5 absolute; the int8 predictor's probabilities on a
# model axis within 1e-4 of one device's (tests/test_int8_serving.py:253).
TP_LOSS_RTOL = 1e-5
TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-4, 1e-5
TP_INT8_PROB_ATOL = 1e-4
# The tensor-parallel forms each case of (b) launches (K7 f32's form is K7
# f32 itself: its dx is f32 already).
TP_CASE_FORMS = {
    "vit_bf16": ["fused_outproj_partial", "fused_mlp_partial",
                 "fused_ln_qkv_bwd_partial", "fused_mlp_bwd_partial"],
    "vit_f32": ["fused_outproj_partial_f32", "fused_mlp_partial_f32",
                "fused_ln_qkv_bwd_f32", "fused_mlp_bwd_partial_f32"],
    "fourd_int8": ["int8_row_amax", "int8_outproj_partial",
                   "int8_mlp_hidden", "int8_mlp_partial",
                   "int8_dequant_residual"],
}
# The whole-width passes whose forms a shard launches instead.
TP_WHOLE_PASSES = ["fused_outproj_residual", "fused_mlp_block",
                   "fused_ln_qkv_bwd", "fused_mlp_bwd",
                   "fused_outproj_residual_f32", "fused_mlp_block_f32",
                   "fused_mlp_bwd_f32", "int8_outproj_residual",
                   "int8_mlp_block", "int8_outproj_residual_f32",
                   "int8_mlp_block_f32"]
# The learning rate of (b)'s cases (_dp_case): after AdamW's first step an
# element whose gradient is below 1e-5 of its tensor's largest moves by up
# to lr on the sign of f32 rounding noise (tests/test_torch_parallel_ranks
# .py), so such elements may differ by 2 lr.
TP_LR = 1e-4


def _tp_shard_counts(depth: int, forwards: int, quant, f32: bool,
                     counters: dict) -> dict:
    """The launches of one tensor-parallel serving run over two shards:
    each block of each forward on each shard, the int8 epilogue twice a
    block (the out-projection's and the MLP's), the whole-width passes
    none."""
    n = depth * forwards * TP_WORLD
    sfx = "_f32" if f32 else ""
    if quant:
        names = [f"int8_ln_qkv{sfx}", f"int8_flash_attention{sfx}",
                 f"int8_row_amax{sfx}", f"int8_outproj_partial{sfx}",
                 f"int8_mlp_hidden{sfx}", "int8_mlp_partial"]
    else:
        names = [f"fused_ln_qkv{sfx}", f"flash_attention{sfx}",
                 f"fused_outproj_partial{sfx}", f"fused_mlp_partial{sfx}"]
    want = _want(names, n, counters)
    if quant:
        want[f"int8_dequant_residual{sfx}"] = 2 * n
    return want


def _tp_serving(ckpt: str, counters: dict) -> dict:
    """(a): the flagship served by a Predictor on a model axis of 2 over
    [cuda:0, cuda:0] at bf16, f32, and int8 of both, against the
    one-replica Predictor on the same weights, 8 volumes in one bucket:
    labels equal; f32 logits within F32_LOGIT_ATOL; int8 of either dtype
    within JAX's TP_INT8_PROB_ATOL and its logits one replica's bit for bit
    (the shards sum their int32 accumulators, exactly, and run the
    epilogue once); bf16 within PROB_ATOL (the shards' f32 sum is rounded
    to bf16 once, and where it lands on the other side of a rounding
    boundary than one card's the residual stream moves by an ulp, and with
    it the next block's codes). Launches of each run checked exactly.
    Returns the runs' launches."""
    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.serving import Predictor
    phase = "tp"
    config = load_config()
    vols = _volumes(np.random.default_rng(SEED + 30), 8,
                    config["TRAINING_VIT_INPUT_SIZE"])
    x = torch.from_numpy(vols).cuda()
    depth = config["MODEL_VIT_DEPTH"]
    total = {name: 0 for name in counters}
    for precision, quant in (("bf16", None), ("f32", None), ("bf16", "int8"),
                             ("f32", "int8")):
        cfg = dict(config, TRAINING_PRECISION=precision)
        one = Predictor.from_checkpoint(cfg, ckpt, batch_size=8,
                                        device="cuda", quant=quant,
                                        bucket_sizes=())
        two = Predictor.from_checkpoint(cfg, ckpt, batch_size=8, quant=quant,
                                        bucket_sizes=(),
                                        devices=["cuda:0", "cuda:0"],
                                        model_axis=2)
        want_labels, want = one(vols)
        forwards = _count_forwards(two.replicas[0])
        _reset(counters)
        labels, probs = two(vols)
        torch.cuda.synchronize()
        launches = _read(counters, total)
        _check_counts(f"tensor-parallel {precision} {quant or ''} serving",
                      launches, _tp_shard_counts(depth, forwards[0], quant,
                                                 precision == "f32",
                                                 counters))
        what = f"{precision}{' int8' if quant else ''}"
        if (labels != want_labels).any():
            raise AssertionError(f"{what}: labels differ from one replica's")
        gap = float(np.abs(probs - want).max())
        with torch.inference_mode():
            lgap = float((two.model(x).float() - one.model(x).float()).abs()
                         .max())
        if quant:
            bound_text = (f"held to JAX's {TP_INT8_PROB_ATOL}; logits "
                          f"{lgap:.3e} apart, held to 0")
            if gap > TP_INT8_PROB_ATOL or lgap != 0.0:
                raise AssertionError(f"{what}: probabilities {gap:.3e} and "
                                     f"logits {lgap:.3e} from one replica's")
        elif precision == "bf16":
            bound_text = f"held to {PROB_ATOL}; logits {lgap:.3e} apart"
            if gap > PROB_ATOL:
                raise AssertionError(f"{what}: probabilities {gap:.3e} from "
                                     "one replica's")
        else:
            bound_text = (f"logits {lgap:.3e} apart, held to "
                          f"{F32_LOGIT_ATOL}")
            if lgap > F32_LOGIT_ATOL:
                raise AssertionError(f"{what}: logits {lgap:.3e} from one "
                                     "replica's")
        log(phase, f"(a) {what}: one replica tensor-parallel over [cuda:0, "
            f"cuda:0] against the one-replica Predictor, 8 volumes: labels "
            f"equal, probabilities {gap:.3e} apart ({bound_text}); launches "
            f"{ {k: v for k, v in launches.items() if v} } ({depth} blocks x "
            f"{TP_WORLD} shards), the whole-width passes none")
        del one, two
        torch.cuda.empty_cache()
    return total


def _tp_rank(rank: int, world: int, workdir: str) -> None:
    """(b)'s rank: a gloo group by a file:// rendezvous on cuda:0, a mesh
    with MESH_MODEL_AXIS 2 (tp 2, dp 1), every case on this rank's shard;
    rank 0's results saved for the parent (its gathered gradients)."""
    import torch.distributed as dist
    from neurovit_tpu_torch.parallel import create_mesh, distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        if not distributed.maybe_initialize({}, torch.device("cuda", 0)):
            raise AssertionError("the port did not adopt the group")
        mesh = create_mesh({"MESH_MODEL_AXIS": world})
        if (mesh.model, mesh.data, mesh.model_index) != (world, 1, rank):
            raise AssertionError(f"the mesh is not tp {world}: {mesh}")
        counters = kernel_counters()
        results = {name: _dp_run_case(name, workdir, counters,
                                      keep=rank == 0, cases=TP_CASES,
                                      keep_state=(rank == 0
                                                  and name == "vit_f32"),
                                      MESH_MODEL_AXIS=world)
                   for name in TP_CASES}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_hold_params(name: str, got: dict, want: dict, grads: dict) -> float:
    """The updated parameters against one process's at JAX's bounds, the
    elements AdamW moved on a noise-signed gradient aside (TP_LR)."""
    worst = 0.0
    for key, w in want.items():
        if not w.is_floating_point():
            continue
        g = got[key].float().cpu()
        w = w.float().cpu()
        diff = (g - w).abs()
        bad = diff > TP_PARAM_ATOL + TP_PARAM_RTOL * w.abs()
        if key in grads and bad.any():
            gr = grads[key].float().cpu()
            noise = gr.abs() <= 1e-5 * gr.abs().max()
            if not (noise[bad].all() and (diff[bad] <= 2 * TP_LR).all()):
                raise AssertionError(f"{name}: {key} {float(diff.max()):.3e} "
                                     "from one process's")
        elif bad.any():
            raise AssertionError(f"{name}: {key} {float(diff.max()):.3e} from "
                                 "one process's")
        worst = max(worst, float(diff.max()))
    return worst


def _tp_hold_ranks(ranks: list, single: dict, states: dict,
                   truth: dict) -> dict:
    """(b): each rank against one process: the loss and count; the
    gathered gradients and updated parameters (f32 at JAX's bounds, bf16
    against the f32 gradients, the int8 4D step at GRAD_RTOL); both ranks'
    digests equal; each TP form of the step launched. Returns rank 0's
    launches summed over the cases."""
    phase = "tp"
    total = {}
    for name in TP_CASES:
        want = single[name]
        for r, res in enumerate(ranks):
            got = res[name]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            bound = TP_LOSS_RTOL if name == "vit_f32" else GRAD_RTOL
            if rel > bound or got["count"] != want["count"]:
                raise AssertionError(
                    f"{name} rank {r}: loss {got['loss']!r} count "
                    f"{got['count']} against one process's {want['loss']!r}"
                    f" {want['count']} (relative {rel:.3e}, held to {bound})")
            for key in ("state_digest", "grad_digest"):
                if got[key] != ranks[0][name][key]:
                    raise AssertionError(f"{name}: rank {r}'s {key} differs "
                                         "from rank 0's")
        launches = ranks[0][name]["launches"]
        forms = TP_CASE_FORMS[name]
        missing = [n for n in forms if not launches.get(n)]
        if missing:
            raise AssertionError(f"{name}: the step launched no {missing}")
        whole = [n for n in TP_WHOLE_PASSES if launches.get(n)]
        if whole:
            raise AssertionError(f"{name}: a shard launched the whole-width "
                                 f"{whole}")
        errs = _dp_grad_errs(ranks[0][name]["grads"], want["grads"])
        held = ""
        if name in truth:
            held = _dp_hold_bf16(name, ranks[0][name]["grads"],
                                 want["grads"], truth[name],
                                 label="tensor-parallel")
        else:
            gbound = F32_GRAD_RTOL if name == "vit_f32" else GRAD_RTOL
            if max(errs.values()) > gbound:
                raise AssertionError(f"{name}: {err_text(errs)} above "
                                     f"{gbound}")
            held = f"; held to {gbound}"
        params = ""
        if name == "vit_f32":
            worst = _tp_hold_params(name, ranks[0][name]["state"],
                                    states[name], want["grads"])
            params = (f"; updated parameters at most {worst:.3e} apart (held "
                      f"to {TP_PARAM_RTOL} rel + {TP_PARAM_ATOL}, AdamW's "
                      "noise-signed elements aside)")
        log(phase, f"(b) {name}: global batch {TP_CASES[name]}, tp "
            f"{TP_WORLD} on cuda:0; loss {ranks[0][name]['loss']!r} against "
            f"one process's {want['loss']!r}; gathered gradients against "
            f"one process: {err_text(errs)}{held}{params}; gradients and "
            f"parameters bit-equal on the {len(ranks)} ranks; forms "
            f"launched { {n: launches[n] for n in forms} }")
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
    return total


def _tp_operands(rng, dtype) -> dict:
    """The flagship block's operands at batch 8 in ``dtype`` (weights f32,
    their int8 forms quantized whole), which _tp_cut cuts."""
    from neurovit_tpu_torch.ops import int8_serving as q8

    def t(*shape, scale=1.0, dt=dtype, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dt, device="cuda")

    def w(out_f, in_f):
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    inner = HEADS * DIM_HEAD
    ops = {"x": t(B, N, DIM), "attn": t(B, N, inner),
           "ln": (t(DIM, scale=0.1, dt=torch.float32, offset=1.0),
                  t(DIM, scale=0.1, dt=torch.float32)),
           "wout": w(DIM, inner),
           "bout": t(DIM, scale=0.03, dt=torch.float32),
           "w1": w(MLP, DIM), "b1": t(MLP, scale=0.03, dt=torch.float32),
           "w2": w(DIM, MLP), "b2": t(DIM, scale=0.02, dt=torch.float32),
           "wqkv": w(3 * inner, DIM), "dy": t(B, N, DIM, scale=0.1),
           "dqkv": t(B, N, 3 * inner, scale=0.1)}
    for name, key in (("out8", "wout"), ("w18", "w1"), ("w28", "w2")):
        ops[name] = q8.quantize_weight(ops[key])
    return ops


def _tp_cut(whole: dict, m: int, tp: int) -> dict:
    """Model index m's shard of the block of _tp_operands: the attention
    output's heads, the weights by the rules of parallel.tensor_parallel
    (the int8 weights cut from the whole's codes), dqkv's heads of q, k
    and v, and h's hidden columns once set."""
    from neurovit_tpu_torch.parallel.tensor_parallel import cut
    inner = whole["attn"].shape[-1]
    part = inner // tp
    dq = whole["dqkv"].reshape(B, N, 3, inner)[..., m * part:(m + 1) * part]
    return {"attn": whole["attn"][..., m * part:(m + 1) * part].contiguous(),
            "wout": cut(whole["wout"], "row", m, tp),
            "w1": cut(whole["w1"], "col", m, tp),
            "b1": cut(whole["b1"], "col", m, tp),
            "w2": cut(whole["w2"], "row", m, tp),
            "wqkv": cut(whole["wqkv"], "heads", m, tp),
            "dqkv": dq.reshape(B, N, 3 * part).contiguous(),
            "out8": (cut(whole["out8"][0], "row", m, tp), whole["out8"][1]),
            "w18": (cut(whole["w18"][0], "col", m, tp),
                    cut(whole["w18"][1], "col", m, tp)),
            "w28": (cut(whole["w28"][0], "row", m, tp), whole["w28"][1])}


def _device_ms(fn, kernels: int, runs: int = 10, tries: int = 3):
    """The profiler's device time of one ``fn()``, which launches
    ``kernels`` kernels: the median over ``tries`` traces of ``runs`` calls
    each of the mean a call, counting only the traces that recorded every
    launch (the profiler loses records on this machine, PERF.md §7).
    Returns (ms or None where no trace was whole, each trace's count of
    kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    readings, counts = [], []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        counts.append(sum(r[2] for r in rows))
        if counts[-1] == kernels * runs:
            readings.append(sum(r[1] for r in rows) / runs)
    return (float(np.median(readings)) if readings else None), counts


def _piece(scratch: torch.Tensor, plan, piece: str, rows: int,
           dtype=torch.int8) -> torch.Tensor:
    """A piece of a K11 / K12 call's scratch: its codes, or K12's f32 g."""
    off, n = plan.scratch[piece]
    return scratch[off:off + n].view(dtype).reshape(rows, -1)


def _tp_form_checks(dtype, rng, tp: int) -> dict:
    """(c) at one dtype: every form against plain on both shards; the
    shards' partials summed against the whole-width pass; the split
    row-quantize's codes against the one-card codes; the int8 shards'
    int32 sums through the epilogue against the one-card passes bit for
    bit. Returns each form's (kernel call, plain call, max abs err, input
    bytes, output bytes, operations, library call or None, whole-width
    call, the kernels a call of the form launches, those of the
    whole-width call), on model index 1's shard, whose f32 partial has no
    bias and no residual."""
    from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv
    from neurovit_tpu_torch.ops import int8_serving as q8
    from neurovit_tpu_torch.ops import tp_forms as F

    sfx = "_f32" if dtype == torch.float32 else ""
    mode = "f32" if sfx else ""
    kind = "f32" if sfx else "bf16"
    # The f32 GEMMs' weight pre-pass: one launch a weight and call.
    split = 1 if sfx else 0
    whole = _tp_operands(rng, dtype)
    sh = [_tp_cut(whole, m, tp) for m in range(tp)]
    x, ln, dy = whole["x"], whole["ln"], whole["dy"]
    rows, inner_m = B * N, sh[0]["attn"].shape[-1]
    hid_m, esz = MLP // tp, x.element_size()
    _, h_all = fused_mlp.fused_mlp_block_plain(
        x, *ln, whole["w1"], whole["b1"], whole["w2"], whole["b2"],
        return_h=True)
    for m, s in enumerate(sh):
        s["h"] = h_all[..., m * hid_m:(m + 1) * hid_m].contiguous()
    out = {}

    def held(name, kernel, plain, summed, full, sum_kw=None, **kw):
        """Each shard's form against plain (``kw``: compare's); the f32
        sum of the shards' outputs, rounded once, against ``full``
        (``sum_kw``, default ``kw``)."""
        worst, parts = 0.0, []
        for m, s in enumerate(sh):
            got, want = kernel(m, s), plain(m, s)
            torch.cuda.synchronize()
            a, _ = compare(f"{name} m={m}", got, want, **kw)
            worst = max(worst, a)
            parts.append(got)
        if full is not None:
            compare(f"{name}: the shards summed", summed(parts), full(),
                    **(kw if sum_kw is None else sum_kw))
        return worst

    def summed_y(parts):
        return (parts[0] + parts[1]).to(dtype)

    err = err_m = 0.0
    for rate in (0.0, DROPOUT):
        drop = {"dropout_rate": rate, "seed": 1234}
        err = max(err, held(
            f"fused_outproj_partial{sfx} dropout {rate}",
            lambda m, s: F.outproj_partial(x, s["attn"], s["wout"],
                                           whole["bout"], first=m == 0,
                                           **drop),
            lambda m, s: F.outproj_partial_plain(x, s["attn"], s["wout"],
                                                 whole["bout"], first=m == 0,
                                                 **drop),
            summed_y, lambda: fused_outproj.fused_outproj_residual(
                x, whole["attn"], whole["wout"], whole["bout"], **drop),
            mode=mode))
        mdrop = {"dropout_rate": rate, "seeds": (1235, 1236)}
        # The shards' hidden masks are their own (a column-parallel site),
        # so their sum is the whole pass's at dropout 0 only.
        err_m = max(err_m, held(
            f"fused_mlp_partial{sfx} dropout {rate}",
            lambda m, s: F.mlp_partial(x, *ln, s["w1"], s["b1"], s["w2"],
                                       whole["b2"], first=m == 0, **mdrop),
            lambda m, s: F.mlp_partial_plain(x, *ln, s["w1"], s["b1"],
                                             s["w2"], whole["b2"],
                                             first=m == 0, **mdrop),
            summed_y, None if rate else lambda: fused_mlp.fused_mlp_block(
                x, *ln, whole["w1"], whole["b1"], whole["w2"], whole["b2"]),
            mode=mode))
    s1 = sh[1]
    out[f"fused_outproj_partial{sfx}"] = (
        lambda: F.outproj_partial(x, s1["attn"], s1["wout"], whole["bout"],
                                  first=False),
        lambda: F.outproj_partial_plain(x, s1["attn"], s1["wout"],
                                        whole["bout"], first=False),
        err, nbytes(s1["attn"]) + s1["wout"].numel() * esz,
        rows * DIM * 4, {kind: 2 * rows * inner_m * DIM},
        (lambda: torch.mm(s1["attn"].reshape(rows, -1),
                          s1["wout"].to(dtype).t(), out_dtype=torch.float32))
        if not sfx else (lambda: torch.mm(s1["attn"].reshape(rows, -1),
                                          s1["wout"].t())),
        lambda: fused_outproj.fused_outproj_residual(
            x, whole["attn"], whole["wout"], whole["bout"]), split + 1,
        split + 1)
    out[f"fused_mlp_partial{sfx}"] = (
        lambda: F.mlp_partial(x, *ln, s1["w1"], s1["b1"], s1["w2"],
                              whole["b2"], first=False),
        lambda: F.mlp_partial_plain(x, *ln, s1["w1"], s1["b1"], s1["w2"],
                                    whole["b2"], first=False),
        err_m, nbytes(x) + 2 * s1["w1"].numel() * esz + 2 * DIM * 4
        + hid_m * 4, rows * DIM * 4, {kind: 4 * rows * DIM * hid_m}, None,
        lambda: fused_mlp.fused_mlp_block(x, *ln, whole["w1"], whole["b1"],
                                          whole["w2"], whole["b2"]),
        2 * split + 3, 2 * split + 3)

    def grads3(r):
        return [r[0], r[-2], r[-1]]

    def summed_grads(parts):
        return [(parts[0][0] + parts[1][0]).to(dtype),
                parts[0][1] + parts[1][1], parts[0][2] + parts[1][2]]

    bwd_kw = {"grads": True, "params": (1, 2)}
    err = held(
        f"fused_mlp_bwd_partial{sfx}",
        lambda m, s: grads3(F.mlp_bwd_partial(dy, x, s["h"], *ln, s["w1"],
                                              s["w2"], first=m == 0)),
        lambda m, s: grads3(F.mlp_bwd_partial_plain(
            dy, x, s["h"], *ln, s["w1"], s["w2"], first=m == 0)),
        summed_grads, lambda: [
            g.reshape(x.shape) if i == 0 else g for i, g in enumerate(
                grads3(fused_mlp.fused_mlp_bwd_plain(
                    dy, x, h_all, *ln, whole["w1"], whole["w2"])))],
        **bwd_kw)
    whole_k9 = (fused_mlp.fused_mlp_bwd_f32_cuda if sfx
                else fused_mlp.fused_mlp_bwd_cuda)
    out[f"fused_mlp_bwd_partial{sfx}"] = (
        lambda: F.mlp_bwd_partial(dy, x, s1["h"], *ln, s1["w1"], s1["w2"],
                                  first=False),
        lambda: F.mlp_bwd_partial_plain(dy, x, s1["h"], *ln, s1["w1"],
                                        s1["w2"], first=False),
        err, nbytes(dy, x, s1["h"]) + 2 * s1["w1"].numel() * esz,
        rows * DIM * 4 + 2 * rows * hid_m * esz + 2 * rows * DIM * esz,
        {kind: 4 * rows * DIM * hid_m}, None,
        lambda: whole_k9(dy, x, h_all, *ln, whole["w1"], whole["w2"]),
        2 * split + 5, 2 * split + 5)
    if not sfx:
        err = held(
            "fused_ln_qkv_bwd_partial",
            lambda m, s: F.ln_qkv_bwd_partial(s["dqkv"], x, ln[0],
                                              s["wqkv"]),
            lambda m, s: F.ln_qkv_bwd_partial_plain(s["dqkv"], x, ln[0],
                                                    s["wqkv"]),
            summed_grads, lambda: [
                g.reshape(x.shape) if i == 0 else g for i, g in enumerate(
                    fused_qkv.fused_ln_qkv_bwd_plain(
                        whole["dqkv"], x, ln[0], whole["wqkv"]))],
            **bwd_kw)
        out["fused_ln_qkv_bwd_partial"] = (
            lambda: F.ln_qkv_bwd_partial(s1["dqkv"], x, ln[0], s1["wqkv"]),
            lambda: F.ln_qkv_bwd_partial_plain(s1["dqkv"], x, ln[0],
                                               s1["wqkv"]),
            err, nbytes(s1["dqkv"], x) + s1["wqkv"].numel() * esz,
            rows * DIM * 4 + 2 * DIM * 4,
            {kind: 2 * rows * 3 * inner_m * DIM}, None,
            lambda: fused_qkv.fused_ln_qkv_bwd_cuda(whole["dqkv"], x, ln[0],
                                                    whole["wqkv"]), 4, 4)

    # int8: the row amax maxed over the shards, the codes against K11's,
    # the shards' int32 accumulators summed and ended by the epilogue
    # against K11's output bit for bit.
    inner = whole["attn"].shape[-1]
    plan11 = q8.int8_outproj_plan(rows, DIM, inner)
    scr11 = q8._scratch(plan11, x, None)
    one_k11 = q8._outproj_cuda(f"nvt_int8_outproj{sfx}", dtype, x,
                               whole["attn"], *whole["out8"], whole["bout"],
                               scr11)
    amaxes, err_a = [], 0.0
    for s in sh:
        amaxes.append(F.int8_row_amax(s["attn"]))
        torch.cuda.synchronize()
        err_a = max(err_a, compare(f"int8_row_amax{sfx}", amaxes[-1],
                                   F.int8_row_amax_plain(s["attn"]),
                                   mode="exact")[0])
    amax = torch.maximum(*amaxes)
    wrap11 = (F.int8_outproj_partial_f32_cuda if sfx
              else F.int8_outproj_partial_cuda)
    plan11m = q8.int8_outproj_plan(rows, DIM, inner_m)
    scrs = [q8._scratch(plan11m, x, None) for _ in sh]
    accs = []
    for m, s in enumerate(sh):
        accs.append(wrap11(s["attn"], amax, s["out8"][0], scratch=scrs[m]))
        torch.cuda.synchronize()
        compare(f"int8_outproj_partial{sfx} m={m}", accs[-1],
                F.int8_outproj_partial_plain(s["attn"], amax, s["out8"][0]),
                mode="exact")
    codes = torch.cat([_piece(c, plan11m, "a8", rows) for c in scrs], dim=1)
    if not torch.equal(codes, _piece(scr11, plan11, "a8", rows)):
        raise AssertionError(f"int8_outproj_partial{sfx}: the split "
                             "row-quantize's codes differ from K11's")
    dequant = (F.int8_dequant_residual_f32_cuda if sfx
               else F.int8_dequant_residual_cuda)
    acc11 = accs[0] + accs[1]
    y11 = dequant(x, acc11, amax, whole["out8"][1], whole["bout"])
    torch.cuda.synchronize()
    compare(f"int8_dequant_residual{sfx}", y11,
            F.int8_dequant_residual_plain(x, acc11, amax, whole["out8"][1],
                                          whole["bout"]), mode="exact")
    compare(f"int8_dequant_residual{sfx}: K11 from the shards' int32 sum",
            y11, one_k11, mode="exact")
    one = lambda: q8.int8_outproj_residual(x, whole["attn"],  # noqa: E731
                                           *whole["out8"], whole["bout"])
    out[f"int8_row_amax{sfx}"] = (
        lambda: F.int8_row_amax(s1["attn"]),
        lambda: F.int8_row_amax_plain(s1["attn"]), err_a, nbytes(s1["attn"]),
        rows * 4, {}, lambda: torch.linalg.vector_norm(
            s1["attn"], ord=float("inf"), dim=-1), one, 1, 2)
    out[f"int8_outproj_partial{sfx}"] = (
        lambda: F.int8_outproj_partial(s1["attn"], amax, s1["out8"][0]),
        lambda: F.int8_outproj_partial_plain(s1["attn"], amax,
                                             s1["out8"][0]),
        0.0, nbytes(s1["attn"], amax, s1["out8"][0]), rows * DIM * 4,
        {"int8": 2 * rows * inner_m * DIM}, None, one, 2, 2)
    out[f"int8_dequant_residual{sfx}"] = (
        lambda: F.int8_dequant_residual(x, acc11, amax, whole["out8"][1],
                                        whole["bout"]),
        lambda: F.int8_dequant_residual_plain(x, acc11, amax,
                                              whole["out8"][1],
                                              whole["bout"]),
        0.0, nbytes(acc11, amax, x) + 2 * DIM * 4, nbytes(x), {}, None, one,
        1, 2)
    # K12: g's amax over the shards' tiles, maxed, the codes against K12's;
    # the accumulators against plain on the kernel's own g (a code of
    # plain's LayerNorm may sit one step off, which int8_mlp_hidden's check
    # bounds), their sum through the epilogue against K12 bit for bit.
    plan12 = q8.mlp_plan(rows, DIM, MLP)
    scr12 = q8._scratch(plan12, x, None)
    one_k12 = q8._mlp_cuda(f"nvt_int8_mlp{sfx}", dtype, x, *ln,
                           *whole["w18"], whole["b1"], *whole["w28"],
                           whole["b2"], scr12)
    hidden = [F.int8_mlp_hidden(x, *ln, *s["w18"], s["b1"]) for s in sh]
    torch.cuda.synchronize()
    err_h = 0.0
    for m, s in enumerate(sh):
        a, _ = compare(f"int8_mlp_hidden{sfx} m={m}", hidden[m][1],
                       F.int8_mlp_hidden_plain(x, *ln, *s["w18"],
                                               s["b1"])[1])
        err_h = max(err_h, a)
    gmax = torch.maximum(hidden[0][1], hidden[1][1])
    plan12m = q8.mlp_plan(rows, DIM, hid_m)
    gk = [_piece(st, plan12m, "g", rows, torch.float32).reshape(B, N, -1)
          for st, _ in hidden]
    accs = []
    for m, s in enumerate(sh):
        accs.append(F.int8_mlp_partial(hidden[m][0], gmax, s["w28"][0]))
        torch.cuda.synchronize()
        compare(f"int8_mlp_partial ({kind} x) m={m}", accs[-1],
                F.int8_mlp_partial_plain(gk[m], gmax, s["w28"][0]),
                mode="exact")
    codes = torch.cat([_piece(st, plan12m, "g8", rows) for st, _ in hidden],
                      dim=1)
    if not torch.equal(codes, _piece(scr12, plan12, "g8", rows)):
        raise AssertionError(f"int8_mlp_partial ({kind} x): the split "
                             "row-quantize's codes of g differ from K12's")
    y12 = dequant(x, accs[0] + accs[1], gmax, whole["w28"][1], whole["b2"])
    torch.cuda.synchronize()
    compare(f"int8_dequant_residual{sfx}: K12 from the shards' int32 sum",
            y12, one_k12, mode="exact")
    one = lambda: q8.int8_mlp_block(x, *ln, *whole["w18"],  # noqa: E731
                                    whole["b1"], *whole["w28"], whole["b2"])
    out[f"int8_mlp_hidden{sfx}"] = (
        lambda: F.int8_mlp_hidden(x, *ln, *s1["w18"], s1["b1"]),
        lambda: F.int8_mlp_hidden_plain(x, *ln, *s1["w18"], s1["b1"]),
        err_h, nbytes(x, s1["w18"][0]) + 8 * DIM + 8 * hid_m,
        rows * 4 + rows * hid_m * 4, {"int8": 2 * rows * DIM * hid_m},
        None, one, 3, 4)
    if not sfx:     # one kernel for both dtypes: g is f32 in the scratch
        out["int8_mlp_partial"] = (
            lambda: F.int8_mlp_partial(hidden[1][0], gmax, s1["w28"][0]),
            lambda: F.int8_mlp_partial_plain(gk[1], gmax, s1["w28"][0]),
            0.0, nbytes(gmax, s1["w28"][0]) + rows * hid_m * 4,
            rows * DIM * 4, {"int8": 2 * rows * hid_m * DIM}, None, one, 2,
            4)
    return out


def _tp_kernel_checks(card: str) -> dict:
    """(c): each tensor-parallel form against its plain version at the
    flagship's tp 2 shard widths (batch 8: 8008 rows, 4 heads of 64, 1024
    hidden columns), at bf16 and f32, on model index 0 (its bias and
    residual) and 1; the shards' partials summed in f32 and rounded once
    against the whole-width kernel; the split row-quantize's codes, and
    the int8 passes from the shards' int32 sums, against the one-card K11's
    and K12's, bit for bit. Each form timed by CUDA events and by the
    profiler's device time (traces that lost a launch's record left out)
    on model index 1's shard, beside its plain version, its bound, a
    library call where one computes the same function, and the
    whole-width pass's times. Runs alone on the card. Returns the stats of
    the kernels JSON line."""
    phase = "tp"
    tp = 2
    rng = np.random.default_rng(SEED + 31)
    stats = {}
    for dtype in (torch.bfloat16, torch.float32):
        forms = _tp_form_checks(dtype, rng, tp)
        for name, (run, plain, err, in_b, out_b, ops, library, whole,
                   k_run, k_whole) in forms.items():
            ms, plain_ms = cuda_ms(run), cuda_ms(plain, warmup=1, runs=3)
            dev_ms, counts = _device_ms(run, k_run)
            whole_dev, whole_counts = _device_ms(whole, k_whole)
            whole_ms = cuda_ms(whole)
            bound_ms, bound_by = bound(in_b, out_b, ops)
            lib_ms = cuda_ms(library) if library is not None else None
            stats[name] = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": lib_ms,
                           "device_ms": dev_ms}
            log(phase, f"(c) {name} at tp {tp} (model index 1's shard, "
                f"batch {B}): kernel {ms:.4f} ms by events, {dev_ms} ms "
                f"device ({k_run} launches a call; the traces of 10 calls "
                f"recorded {counts}); plain {plain_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms by {bound_by}; library {lib_ms} ms; the "
                f"whole-width pass {whole_ms:.4f} ms by events, {whole_dev} "
                f"ms device ({k_whole} launches a call; {whole_counts}); max "
                f"abs err {err:.3e}; {card}")
        torch.cuda.empty_cache()
    return stats


def _tp_dryrun(card: str) -> None:
    """The dry run's entry point on the card: dryrun_multichip(TP_WORLD),
    its ranks on cuda:0 over gloo, each part held to one process by its own
    bounds (it raises where one is not met)."""
    from neurovit_tpu_torch.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    sys.stdout.flush()
    dryrun_multichip(TP_WORLD)
    log("tp", f"(d) dryrun_multichip({TP_WORLD}) on the card (its ranks on "
        f"cuda:0 over gloo): every part held to one process, in "
        f"{time.perf_counter() - t0:.1f} s; {card}")


def tp_phase(config, ckpt: str, workdir: str, card: str,
             counters: dict) -> tuple:
    """Tensor parallelism: (c) the tensor-parallel forms against their
    plain versions, timed alone on the card; then (b) two ranks at tp 2 on
    the one card over gloo against one process, which run while this
    process runs their one-process cases and (a) serving on a model axis of
    2 over [cuda:0, cuda:0]; then (d) the dry run's entry point on the
    card. Two ranks share one card, so nothing here is a speed-up. Returns
    ((c)'s stats, the launches of (a) and of (b)'s rank 0)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    stats = _tp_kernel_checks(card)
    rdv = os.path.join(workdir, "tp", "ranks")
    os.makedirs(rdv)
    ctx = mp.start_processes(_tp_rank, args=(TP_WORLD, rdv),
                             nprocs=TP_WORLD, join=False,
                             start_method="spawn")
    try:
        single, states = {}, {}
        for name in TP_CASES:
            single[name] = _dp_run_case(name, rdv, counters, cases=TP_CASES,
                                        keep_state=name == "vit_f32")
        truth = {"vit_bf16": single["vit_f32"]["grads"]}
        states["vit_f32"] = single["vit_f32"].pop("state")
        torch.cuda.empty_cache()
        total = _tp_serving(ckpt, counters)
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError("(b)'s ranks did not finish in 600 s")
        ranks = [torch.load(os.path.join(rdv, f"rank{r}.pt"),
                            weights_only=True) for r in range(TP_WORLD)]
        for name, n in _tp_hold_ranks(ranks, single, states, truth).items():
            total[name] += n
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    del ranks, single, states, truth
    torch.cuda.empty_cache()
    _tp_dryrun(card)
    log("tp", f"done in {time.perf_counter() - t0:.1f} s; launches "
        f"{ {n: c for n, c in total.items() if c} }; {card}")
    return stats, total


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches, by
    the kernel's name."""
    from neurovit_tpu_torch.ops import (dropout, flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv, int8_gemm,
                                        int8_serving, maxpool3d, tf32x3,
                                        tp_forms)
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
        "flash_attention_f32": flash_attention.flash_attention_f32_cuda,
        "fused_ln_qkv_f32": fused_qkv.fused_ln_qkv_f32_cuda,
        "fused_outproj_residual_f32":
            fused_outproj.fused_outproj_residual_f32_cuda,
        "fused_mlp_block_f32": fused_mlp.fused_mlp_block_f32_cuda,
        "fused_fwd_wsplit_f32": tf32x3.split_cuda,
        "flash_attention_bwd_f32": flash_attention.flash_attention_bwd_f32_cuda,
        "fused_ln_qkv_bwd_f32": fused_qkv.fused_ln_qkv_bwd_f32_cuda,
        "fused_outproj_bwd_f32": fused_outproj.fused_outproj_bwd_f32_cuda,
        "fused_outproj_bwd_wsplit_f32": tf32x3.split_t_cuda,
        "fused_mlp_bwd_f32": fused_mlp.fused_mlp_bwd_f32_cuda,
        "int8_ln_qkv_f32": int8_serving.int8_ln_qkv_f32_cuda,
        "int8_outproj_residual_f32":
            int8_serving.int8_outproj_residual_f32_cuda,
        "int8_mlp_block_f32": int8_serving.int8_mlp_block_f32_cuda,
        "int8_flash_attention_f32":
            int8_serving.int8_flash_attention_f32_cuda,
        "flash_attention_bhnd_f32":
            flash_attention.flash_attention_bhnd_f32_cuda,
        "flash_attention_bhnd_bwd_f32":
            flash_attention.flash_attention_bhnd_bwd_f32_cuda,
        **tp_forms.CUDA_WRAPPERS,
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

    seconds = {}

    def timed(name: str, fn, *args):
        """Run a phase, keep its seconds by the host's clock, and free the
        card's cached blocks after it."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    seconds["build"] = round(time.perf_counter() - t0, 1)
    log("build", f"{lib.name} in {seconds['build']} s")
    build_notes(lib)

    kernel_stats = timed("kernels", kernel_phase, card)
    counters = kernel_counters()
    timed("widths", widths_phase, card)
    probe_stats, probe_launches = timed("probes", probes_phase, card,
                                        counters)
    kernel_stats.update(probe_stats)
    config = load_config()
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as workdir:
        ckpt = os.path.join(workdir, "flagship.pt")
        torch.save(NeuroEncoder(config, device="cpu", seed=SEED).state_dict(),
                   ckpt)

        def serve() -> None:
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
            log("http", f"serving: {forwards[0]} forward calls x depth "
                f"{depth}; launches {serving}")
            _check_counts("serving", serving, {
                name: 0 if name.endswith("_bwd")
                or name in OFF_BLOCK_KERNELS
                else depth * forwards[0] for name in counters})

        timed("slice+http", serve)
        int8_launches = timed("int8", int8_phase, config, ckpt, rng, workdir,
                              counters)
        timed("rate", rate_phase, config, ckpt, card)
        gradcam_launches = timed("gradcam", gradcam_phase, config, ckpt,
                                 workdir, card, counters)
        timed("grad", grad_phase, config)
        launches = timed("train", train_phase, config, workdir, counters)
        timed("train_rate", train_rate_phase, config, workdir, card)
        feature_launches = timed("train_features", train_features_phase,
                                 config, workdir, card, counters)
        resnet_launches = timed("resnet", resnet_phase, config, workdir, card,
                                counters)
        fourd_launches = timed("4d", fourd_phase, workdir, card, counters)
        f32_stats, f32_launches = timed("f32", f32_phase, config, ckpt,
                                        workdir, card, counters)
        kernel_stats.update(f32_stats)
        timed("widths_model", widths_model_phase, config, workdir, counters)
        dp_launches = timed("dp", dp_phase, config, ckpt, workdir, card,
                            counters)
        tp_stats, tp_launches = timed("tp", tp_phase, config, ckpt, workdir,
                                      card, counters)
        kernel_stats.update(tp_stats)

    launches.update({name: int8_launches[name] for name in INT8_KERNELS})
    launches.update(probe_launches)
    launches.update({name: gradcam_launches[name]
                     for name in GRADCAM_KERNELS})
    launches.update({name: resnet_launches[name] for name in RESNET_KERNELS})
    for name, n in fourd_launches.items():
        launches[name] += n
    for name, n in feature_launches.items():
        launches[name] += n
    for name in F32_KERNELS + INT8_F32_KERNELS + F32_GRADCAM_KERNELS:
        launches[name] = f32_launches[name]
    for name, n in dp_launches.items():
        launches[name] += n
    for name, n in tp_launches.items():
        launches[name] += n
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **{key: kernel_stats[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "device_ms", "library_device_ms")
            if key in kernel_stats[name]}}
        for name, source, replaces in KERNELS]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"seconds by phase {seconds}")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
