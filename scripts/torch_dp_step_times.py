#!/usr/bin/env python3
"""The port's train step through the data-parallel path beside the
one-process step, on the card, under torchrun:

    torchrun --standalone --nproc_per_node=N scripts/torch_dp_step_times.py \
        [--batch 128] [--warmup 3] [--runs 5] [--precision bf16]

Every rank builds the flagship ViT (configs/config.yaml, seed 42, dropout
0.1) on ``cuda:LOCAL_RANK`` twice: one Trainer on the process group
(NCCL: the valid-count and metric all-reduces, the coalesced gradient
all-reduce, the preemption flag on gloo) at the global batch ``--batch`` x
N, and one Trainer on a one-process mesh at the local batch ``--batch``.
Each times ``--runs`` steps on one seeded batch after ``--warmup`` steps,
by the host clock around ``torch.cuda.synchronize()``, in turns (plain,
data-parallel, data-parallel, plain). Rank 0 prints a line per turn, the
card's name and power limit, and one JSON object as its last line. Without
a card it exits 1; without torchrun's variables it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


class _Volumes:
    """Seeded 90^3 volumes: the Trainers' loaders need a dataset; the
    timed steps read one batch made on the card."""

    def __init__(self, n: int, size: int):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.default_rng(idx)
        return {"volume": rng.standard_normal((self.size,) * 3,
                                              dtype=np.float32),
                "label": idx % 2}


def _time(trainer, batch, warmup: int, runs: int) -> list:
    times = []
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128,
                        help="rows a rank (the global batch is N times it)")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--precision", default="bf16", choices=("bf16",
                                                                "f32"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dp_step_times: CUDA is not available", file=sys.stderr)
        return 1
    if "LOCAL_RANK" not in os.environ:
        print("torch_dp_step_times: run it under torchrun", file=sys.stderr)
        return 2

    from neurovit_tpu_torch.config import load_config
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.parallel import Mesh, create_mesh, distributed
    from neurovit_tpu_torch.training import Trainer

    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    config = load_config()
    if not distributed.maybe_initialize(config, device):
        raise RuntimeError("no process group under torchrun")
    world, rank = distributed.world_size(), distributed.rank()
    size = config["TRAINING_VIT_INPUT_SIZE"]
    with tempfile.TemporaryDirectory() as workdir:
        cfg = {**config, "TRAINING_PRECISION": args.precision,
               "TRAINING_BATCH_SIZE": args.batch * world,
               "TRAINING_NUM_WORKERS": 1, "WANDB_ENABLED": False,
               "GLOBAL_OUTPUT_DIR": workdir}
        data = _Volumes(max(2 * args.batch * world, world), size)
        dp = Trainer(cfg, NeuroEncoder(cfg, device=device, seed=42), data,
                     data)
        one = Trainer(dict(cfg, TRAINING_BATCH_SIZE=args.batch),
                      NeuroEncoder(cfg, device=device, seed=42), data, data,
                      mesh=Mesh(create_mesh(cfg).shape))
        gen = torch.Generator(device=device).manual_seed(1000 + rank)
        batch = {"volume": torch.randn((args.batch,) + (size,) * 3,
                                       generator=gen, device=device),
                 "label": torch.randint(0, 2, (args.batch,), generator=gen,
                                        device=device),
                 "valid": torch.ones(args.batch, dtype=torch.bool,
                                     device=device)}
        turns = {"plain": [], "dp": []}
        for name, trainer in (("plain", one), ("dp", dp), ("dp", dp),
                              ("plain", one)):
            times = _time(trainer, batch, args.warmup, args.runs)
            turns[name].append(times)
            if rank == 0:
                print(f"{name}: batch {args.batch} a rank, world {world}: "
                      f"median {np.median(times):.2f} ms of {args.runs} "
                      f"({[round(t, 2) for t in times]})", flush=True)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    distributed.shutdown()
    if rank == 0:
        card = _card()
        print(card)
        print(json.dumps({
            "card": card, "world": world, "batch_per_rank": args.batch,
            "precision": args.precision,
            "backend": "nccl",
            "plain_ms": [float(np.median(t)) for t in turns["plain"]],
            "dp_ms": [float(np.median(t)) for t in turns["dp"]],
            "peak_gib": round(peak, 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
