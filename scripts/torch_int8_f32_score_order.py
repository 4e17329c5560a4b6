"""How the order of K13 f32's score sums moves the f32 int8 flagship's
output, on the CPU.

``chip_smoke.py``'s f32 phase (h) holds the seed-42 flagship, served at f32
with ``quant="int8"`` on the card, to the CPU's plain path: its logits
within ``INT8_F32_LOGIT_ATOL`` and its probabilities within
``F32_LOGIT_ATOL``. Each block's attention rounds p / s_p to int8 codes, so
a score summed in another order than the plain version's f32 matmul moves
a few codes, and the model's output with them. This script runs (h)'s
three volumes through the CPU's f32 int8 model with K13's scores taken in
each of these orders, and prints each one's largest logit and probability
difference from the plain path:

- ``torch.matmul`` (the plain version; again through the same code path,
  which must read 0);
- one rounded fused multiply-add at a time along D, column 0 first (the
  order K13 f32 takes again near a code's rounding boundary);
- f64, rounded once (a kernel whose every score is exact);
- 3xTF32 with a fresh accumulator every k8 step (K13 f32's tensor-core
  scores, ``tests/test_torch_int8_f32.py``'s model);

and, beside them, the plain path's own drift when every voxel moves by one
ulp, (h)'s witness.

    python scripts/torch_int8_f32_score_order.py [--threads 4]

CPU only; about ten minutes at four threads.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from neurovit_tpu_torch.config import load_config  # noqa: E402
from neurovit_tpu_torch.models import NeuroEncoder  # noqa: E402
from neurovit_tpu_torch.models.vit3d import quantize_blocks  # noqa: E402
from neurovit_tpu_torch.ops import int8_serving as q8  # noqa: E402
from neurovit_tpu_torch.ops.flash_attention import (LOG2E,  # noqa: E402
                                                    SCORE_CAP)

SEED = 42


def heads_first(q, k):
    return (t.permute(0, 2, 1, 3) for t in (q, k))


def matmul_scores(q, k):
    qf, kf = heads_first(q, k)
    return torch.matmul(qf, kf.transpose(-1, -2))


def fma_scores(q, k):
    """One rounded fused multiply-add at a time along D: each f32 product
    is exact in f64, and the sum is rounded once to f32."""
    qf, kf = heads_first(q, k)
    s = torch.zeros(qf.shape[:-1] + (kf.shape[2],))
    for d in range(qf.shape[-1]):
        s = (s.double() + qf[..., d:d + 1].double()
             * kf[..., d].double()[..., None, :]).float()
    return s


def f64_scores(q, k):
    qf, kf = heads_first(q, k)
    return torch.matmul(qf.double(), kf.double().transpose(-1, -2)).float()


def tf32x3_scores(q, k):
    """3xTF32 on mma.sync: each operand split into big (rounded to TF32)
    and small (truncated to TF32); per k8 step small . big, big . small,
    big . big into a fresh accumulator, each MMA's sum rounded toward zero,
    then added to the score in f32."""
    def split(x):
        bits = x.contiguous().view(torch.int32)
        big = ((bits + 0x1000) & -0x2000).view(torch.float32)
        small = ((x - big).contiguous().view(torch.int32)
                 & -0x2000).view(torch.float32)
        return big, small

    def rz(x):
        f = x.float()
        return torch.where(f.double().abs() > x.abs(),
                           torch.nextafter(f, torch.zeros_like(f)), f)

    qf, kf = heads_first(q, k)
    (ab, as_), (bb, bs) = split(qf), split(kf.transpose(-1, -2))
    s = torch.zeros(qf.shape[:-1] + (kf.shape[2],))
    for k0 in range(0, qf.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        part = torch.zeros_like(s)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            part = rz(part.double()
                      + x[..., sl].double() @ y[..., sl, :].double())
        s = s + part
    return s


def with_scores(scores):
    """K13's plain function on the scores ``scores(q, k)`` [B, H, N, N]."""
    def k13(q, k, v, *, scale, n_valid=None):
        n = q.shape[1]
        n_valid = n if n_valid is None else n_valid
        vf = v.permute(0, 2, 1, 3)
        p = torch.exp2(torch.clamp(scores(q, k) * (scale * LOG2E),
                                   -SCORE_CAP, SCORE_CAP))
        p = p * (torch.arange(n) < n_valid).float()
        s_p = q8._scale(p.amax(dim=-1, keepdim=True))
        p8 = torch.clamp(torch.round(p / s_p), 0, 127)
        s_v = q8._scale(vf[:, :, :n_valid].abs().amax(dim=2, keepdim=True))
        v8 = torch.clamp(torch.round(vf / s_v), -127, 127)
        acc = torch.matmul(p8.double(), v8.double()).float()
        o = acc * (s_p / p.sum(dim=-1, keepdim=True) * s_v)
        return o.permute(0, 2, 1, 3).contiguous()
    return k13


def diffs(got, want) -> str:
    """The largest logit and probability differences."""
    probs = (got.softmax(-1) - want.softmax(-1)).abs().max()
    return (f"logits {float((got - want).abs().max()):.3e}, probabilities "
            f"{float(probs):.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    config = dict(load_config(), TRAINING_PRECISION="f32")
    size = config["TRAINING_VIT_INPUT_SIZE"]
    state = NeuroEncoder(config, device="cpu", seed=SEED).state_dict()
    model = NeuroEncoder(config, device="cpu", seed=SEED + 5).eval()
    model.load_state_dict(state)
    quantize_blocks(model.volume_encoder.vit3d)
    # (h)'s volumes: its generator after the NIfTI scan it writes first.
    rng = np.random.default_rng(SEED + 26)
    rng.standard_normal((91, 109, 91))
    vols = rng.standard_normal((3, size, size, size)).astype(np.float32)
    plain = q8.int8_flash_attention_plain
    try:
        with torch.inference_mode():
            want = model(torch.from_numpy(vols))
            for name, scores in (("torch.matmul", matmul_scores),
                                 ("one FMA at a time", fma_scores),
                                 ("f64", f64_scores),
                                 ("3xTF32, fresh every k8 step",
                                  tf32x3_scores)):
                q8.int8_flash_attention_plain = with_scores(scores)
                got = model(torch.from_numpy(vols))
                print(f"scores {name}: {diffs(got, want)}", flush=True)
            q8.int8_flash_attention_plain = plain
            moved = model(torch.from_numpy(np.nextafter(vols, np.float32(
                np.inf))))
            print(f"the plain path with every voxel one ulp up: "
                  f"{diffs(moved, want)}")
    finally:
        q8.int8_flash_attention_plain = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
