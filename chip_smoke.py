#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (neurovit_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:

1. device   nvidia-smi's name and power limit, torch's device name
2. build    compile the four kernels from neurovit_tpu_torch/csrc
3. kernels  each kernel against its plain PyTorch version on the card, at
            the flagship serving shapes, with CUDA-event timings of both
4. slice    the flagship model (configs/config.yaml, seed 42) saved with
            torch.save, served by Predictor.from_checkpoint on cuda:
            warmup, then requests of 1, 3 and 32 volumes; checked against
            single-volume calls and against the same model on the CPU
5. http     the HTTP server on an ephemeral port: /healthz, then /predict
            with three NIfTI files, two of them posted concurrently
6. counts   every kernel launched depth times per forward of phases 4-5

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, the script exits
non-zero before printing either.
"""

from __future__ import annotations

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
# Probabilities from different batch buckets, from HTTP and from the CPU
# plain path: the same rounding points, six layers deep.
PROB_ATOL = 2e-2

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
]


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


def compare(name: str, got, want) -> tuple:
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    max_abs, max_rel = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        diff = (g - w).abs()
        bad = diff > ATOL + RTOL * w.abs()
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel, float(diff.max() / w.abs().max()))
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} elements outside "
                f"{ATOL} + {RTOL} * |plain| (max abs err {max_abs:.3e})")
    return max_abs, max_rel


def kernel_phase(card: str) -> dict:
    from neurovit_tpu_torch.ops import (flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv)

    rng = np.random.default_rng(SEED)
    dev = "cuda"

    def t(*shape, scale=1.0, dtype=torch.bfloat16, offset=0.0):
        a = offset + scale * rng.standard_normal(shape)
        return torch.tensor(a, dtype=dtype, device=dev)

    def w(out_f, in_f):   # nn.Linear's default range
        a = rng.uniform(-1, 1, (out_f, in_f)) / in_f ** 0.5
        return torch.tensor(a, dtype=torch.float32, device=dev)

    inner = HEADS * DIM_HEAD
    x = t(B, N, DIM)
    qkv = [t(B, N, HEADS, DIM_HEAD) for _ in range(3)]
    scale = DIM_HEAD ** -0.5
    ln = (t(DIM, scale=0.1, dtype=torch.float32, offset=1.0),
          t(DIM, scale=0.1, dtype=torch.float32))
    cases = {
        "flash_attention": (
            flash_attention.flash_attention_cuda,
            flash_attention.flash_attention_plain,
            [(tuple(qkv), {"scale": scale, "n_valid": N}),
             (tuple(qkv), {"scale": scale, "n_valid": N_VALID_MASKED})]),
        "fused_ln_qkv": (
            fused_qkv.fused_ln_qkv_cuda, fused_qkv.fused_ln_qkv_plain,
            [((x, *ln, w(3 * inner, DIM), HEADS, DIM_HEAD), {})]),
        "fused_outproj_residual": (
            fused_outproj.fused_outproj_residual_cuda,
            fused_outproj.fused_outproj_residual_plain,
            [((x, t(B, N, inner), w(DIM, inner),
               t(DIM, scale=0.03, dtype=torch.float32)), {})]),
        "fused_mlp_block": (
            fused_mlp.fused_mlp_block_cuda, fused_mlp.fused_mlp_block_plain,
            [((x, *ln, w(MLP, DIM), t(MLP, scale=0.03, dtype=torch.float32),
               w(DIM, MLP), t(DIM, scale=0.02, dtype=torch.float32)), {})]),
    }
    results = {}
    for name, (kernel, plain, calls) in cases.items():
        max_abs, max_rel = 0.0, 0.0
        for args, kwargs in calls:
            got = kernel(*args, **kwargs)
            want = plain(*args, **kwargs)
            torch.cuda.synchronize()
            a, r = compare(f"{name} {kwargs or ''}", got, want)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        args, kwargs = calls[0]
        ms = cuda_ms(lambda: kernel(*args, **kwargs))
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs))
        results[name] = {"max_abs_err": max_abs, "max_rel_err": max_rel,
                         "ms": ms, "plain_ms": plain_ms}
        log("kernels", f"{name}: max abs err {max_abs:.3e}, max rel err "
            f"{max_rel:.3e} (tol {ATOL} + {RTOL:.4g}*|plain|); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms at B={B} N={N}; {card}")
    return results


def _volumes(rng, n: int, size: int) -> np.ndarray:
    return rng.standard_normal((n, size, size, size)).astype(np.float32)


def slice_phase(config, ckpt: str, predictor, rng) -> None:
    from neurovit_tpu_torch.models import NeuroEncoder
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
        singles[n] = (vols[0], probs[0])
        log("slice", f"n={n}: bucket {predictor._bucket_for(n)}, "
            f"{secs * 1e3:.1f} ms host clock, probs[0] {probs[0].tolist()}, "
            f"max diff vs single calls {worst:.3e} (tol {PROB_ATOL})")

    # The same checkpoint on the CPU plain path.
    cpu_model = NeuroEncoder(config, device="cpu", seed=SEED)
    load_checkpoint(cpu_model, ckpt, strict=True)
    vol, gpu_probs = singles[1]
    with torch.inference_mode():
        logits = cpu_model(torch.from_numpy(vol[None]))
        cpu_probs = torch.softmax(logits.float(), dim=-1)[0].numpy()
    diff = float(np.abs(cpu_probs - gpu_probs).max())
    log("slice", f"cuda vs cpu plain path: probs {gpu_probs.tolist()} vs "
        f"{cpu_probs.tolist()}, max diff {diff:.3e} (tol {PROB_ATOL})")
    if diff > PROB_ATOL:
        raise AssertionError(f"cuda and cpu probabilities differ by {diff}")


def http_phase(predictor, rng, workdir: str) -> None:
    from neurovit_tpu.data import nifti
    from neurovit_tpu_torch.serving import _collect_volume_jobs
    from neurovit_tpu_torch.serving_http import make_server

    paths = []
    for i in range(3):
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
            if resp.status != 200 or health["status"] != "ok":
                raise AssertionError(f"/healthz: {resp.status} {health}")
        log("http", f"/healthz {health}")
        for path in paths:
            post(path)
        concurrent = [threading.Thread(target=post, args=(p,))
                      for p in paths[:2]]
        for c in concurrent:
            c.start()
        for c in concurrent:
            c.join(timeout=300)
            if c.is_alive():
                raise AssertionError("a concurrent POST did not finish")
    finally:
        server.shutdown()
        batcher.stop()
        thread.join(timeout=60)
        server.server_close()
    if len(results) != len(paths) + 2:
        raise AssertionError(f"{len(results)} of {len(paths) + 2} POSTs "
                             "answered")
    for path, status, payload in results:
        got = np.array(payload["rows"][0]["probs"])
        diff = float(np.abs(got - want[path]).max())
        log("http", f"POST {os.path.basename(path)}: {status}, probs "
            f"{got.tolist()}, max diff vs Predictor {diff:.3e}")
        if status != 200 or diff > PROB_ATOL:
            raise AssertionError(f"{path}: status {status}, diff {diff}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on the card only", file=sys.stderr)
        return 1
    from neurovit_tpu.config import load_config
    from neurovit_tpu_torch.ops import (_build, flash_attention, fused_mlp,
                                        fused_outproj, fused_qkv)
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

    counters = {
        "flash_attention": flash_attention.flash_attention_cuda,
        "fused_ln_qkv": fused_qkv.fused_ln_qkv_cuda,
        "fused_outproj_residual": fused_outproj.fused_outproj_residual_cuda,
        "fused_mlp_block": fused_mlp.fused_mlp_block_cuda,
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
        forwards = [0]
        predictor.model.register_forward_hook(
            lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        predictor.warmup()
        log("slice", f"warmup of buckets {predictor.bucket_sizes}: "
            f"{time.perf_counter() - t0:.1f} s")
        slice_phase(config, ckpt, predictor, rng)
        http_phase(predictor, rng, workdir)
        launches = {name: fn.launches for name, fn in counters.items()}

    log("counts", f"{forwards[0]} forward calls x depth {depth}; launches "
        f"{launches}")
    for name, count in launches.items():
        if count == 0 or count != depth * forwards[0]:
            raise AssertionError(f"{name} launched {count} times, expected "
                                 f"{depth} x {forwards[0]}")

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
