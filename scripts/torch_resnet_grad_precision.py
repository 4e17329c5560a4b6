"""How far the port's ResNet gradients move with the compute precision, on
the CPU plain path.

The ResNet-18 of ``configs/config.yaml`` (``MODEL_VOLUME_ENCODER: resnet``,
weights from seed 42) on two seeded normal volumes with labels (0, 1), as
in ``chip_smoke.py``'s gradient check, at a cut volume size.
For train and eval mode it prints each parameter gradient's relative
Frobenius error, bf16 compute against f32 (the parameters in f32, as the
port keeps them), worst and median, and the error of the gradient with
respect to each stage's output (the stem, its pool, each block, the
logits).

    python scripts/torch_resnet_grad_precision.py [--size 45] [--threads 4]
"""

import argparse
import copy
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurovit_tpu_torch.config import load_config  # noqa: E402
from neurovit_tpu_torch.models import NeuroEncoder  # noqa: E402
from neurovit_tpu_torch.models.resnet3d import batch_norm, conv3d  # noqa: E402
from neurovit_tpu_torch.ops.maxpool3d import max_pool3d  # noqa: E402

SEED = 42


def run(model, vols, dtype, train: bool):
    """Parameter gradients and stage-output gradients (f32) of the
    cross-entropy loss, computing in ``dtype``, for a copy of ``model``."""
    m = copy.deepcopy(model)
    stages = {}

    def keep(name, h):
        h.retain_grad()
        stages[name] = h
        return h

    h = keep("stem", conv3d(vols.to(dtype), m.conv1.weight, (1, 2, 2), 3))
    h = torch.relu(batch_norm(m.bn1, h, train=train))
    h = keep("pool", max_pool3d(h.permute(0, 2, 3, 4, 1).contiguous()
                                ).permute(0, 4, 1, 2, 3))
    for s in range(4):
        for i, block in enumerate(getattr(m, f"layer{s + 1}")):
            h = keep(f"layer{s + 1}.{i}", block(h, train=train))
    logits = keep("logits", m.head(h))
    F.cross_entropy(logits, torch.tensor([0, 1])).backward()
    params = {n: p.grad.float() for n, p in m.named_parameters()}
    return params, {n: t.grad.float() for n, t in stages.items()}


def errs(got: dict, want: dict) -> dict:
    return {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items()}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=45)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    config = dict(load_config(), MODEL_VOLUME_ENCODER="resnet",
                  TRAINING_VIT_INPUT_SIZE=args.size, TRAINING_PRECISION="f32")
    model = NeuroEncoder(config, device="cpu", seed=SEED).resnet_3d.resnet
    rng = np.random.default_rng(SEED + 1)
    vols = torch.from_numpy(rng.standard_normal(
        (2, 1) + (args.size,) * 3, dtype=np.float32))
    print(f"ResNet-18, seed {SEED}, batch 2 at {args.size}^3, CPU, torch "
          f"{torch.__version__}")
    for train in (True, False):
        mode = "train" if train else "eval"
        (p16, s16), (p32, s32) = (run(model, vols, dt, train)
                                  for dt in (torch.bfloat16, torch.float32))
        e = errs(p16, p32)
        worst = max(e, key=e.get)
        print(f"{mode}, bf16 against f32: {len(e)} parameter gradients, "
              f"worst {worst} at {e[worst]:.3e}, median "
              f"{float(np.median(list(e.values()))):.3e}")
        print(f"{mode}, bf16 against f32, stage-output gradients: "
              + ", ".join(f"{n} {v:.1e}" for n, v in errs(s16, s32).items()))


if __name__ == "__main__":
    main()
