"""The 3D f32 train step that the f32 backwards K5, K7, K8 and K9
(csrc/*_bwd_f32.cu) open on the card, as far as the CPU reaches it: the
route of one tiny f32 ``Trainer`` step with the operands taken as on the
card (each f32 kernel replaced by a spy that runs its plain version), and
K5 f32's two tile walks modelled in numpy against the plain backward,
with its dropout bits against ``nn.keep_mask``. The kernels themselves run
on the card only (tests/test_torch_cuda.py, chip_smoke.py's ``f32``
phase); the f32 step's parity with the JAX Trainer is
tests/test_torch_train.py's and tests/test_torch_train_parity.py's.

Tolerance of the numpy model against the plain backward: 1e-5 abs + 1e-4
rel (float64 sums against the plain version's f32 matmuls).
"""

import numpy as np
import pytest
import torch

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.config import load_config
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.ops import common
from neurovit_tpu_torch.ops import flash_attention as fa
from neurovit_tpu_torch.ops import fused_mlp, fused_outproj, fused_qkv
from neurovit_tpu_torch.training import Trainer

torch.set_num_threads(1)

BATCH, DEPTH = 4, 2
TINY = {"TRAINING_VIT_INPUT_SIZE": 20, "TRAINING_VIT_PATCH_SIZE": 5,
        "DATASET_NAME": "adni", "TRAINING_PRECISION": "f32",
        "TRAINING_DROPOUT": 0.1, "MODEL_VIT_DIM": 64,
        "MODEL_VIT_DEPTH": DEPTH, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 16, "MODEL_VIT_MLP_DIM": 128,
        "TRAINING_BATCH_SIZE": BATCH, "TRAINING_NUM_WORKERS": 0,
        "TRAINING_LEARNING_RATE": 1e-3, "WANDB_ENABLED": False}

# (module, the op's plain, bf16 and f32 versions by name), forward and
# backward, for the three GEMM ops; the attention's are in fa._IMPLS.
GEMM_OPS = [
    (fused_qkv, "fused_ln_qkv_plain", "fused_ln_qkv_cuda",
     "fused_ln_qkv_f32_cuda"),
    (fused_qkv, "fused_ln_qkv_bwd_plain", "fused_ln_qkv_bwd_cuda",
     "fused_ln_qkv_bwd_f32_cuda"),
    (fused_outproj, "fused_outproj_residual_plain",
     "fused_outproj_residual_cuda", "fused_outproj_residual_f32_cuda"),
    (fused_outproj, "fused_outproj_bwd_plain", "fused_outproj_bwd_cuda",
     "fused_outproj_bwd_f32_cuda"),
    (fused_mlp, "fused_mlp_block_plain", "fused_mlp_block_cuda",
     "fused_mlp_block_f32_cuda"),
    (fused_mlp, "fused_mlp_bwd_plain", "fused_mlp_bwd_cuda",
     "fused_mlp_bwd_f32_cuda"),
]


class _Volumes:
    def __len__(self):
        return 2 * BATCH

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20).astype(np.float32),
                "label": idx % 2, "subject": f"s{idx}", "timepoint": 0}


def _step(config):
    """One train step of a fresh seeded model on a fixed batch: (loss,
    the updated parameters)."""
    model = NeuroEncoder(config, device="cpu", seed=3)
    trainer = Trainer(config, model, _Volumes(), _Volumes())
    rng = np.random.RandomState(5)
    batch = {"volume": torch.from_numpy(
        rng.randn(BATCH, 20, 20, 20).astype(np.float32)),
        "label": torch.tensor([0, 1, 1, 0]),
        "valid": torch.ones(BATCH, dtype=torch.bool)}
    loss = float(trainer.train_step(batch)["loss"])
    return loss, {k: v.clone() for k, v in model.state_dict().items()}


def test_f32_train_step_routes_through_the_f32_kernels(tmp_path,
                                                       monkeypatch):
    """With the operands taken as on the card, one f32 3D train step at
    dropout 0.1 calls K1-K4 at f32 once a block forward and K5, K7, K8 and
    K9 at f32 once a block backward, and no bf16 kernel; each spy runs the
    plain version, so the loss and every updated parameter equal the CPU
    plain route's bit for bit."""
    config = load_config(overrides=dict(
        TINY, GLOBAL_OUTPUT_DIR=str(tmp_path)))
    want_loss, want = _step(config)

    calls = {}

    def spy(name, fn):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"the f32 step ran the bf16 kernel {name}")
        return run

    for module in (common, fa):
        monkeypatch.setattr(module, "on_cpu", lambda *_: False)
    for module, plain, bf16, f32 in GEMM_OPS:
        monkeypatch.setattr(module, f32, spy(f32, getattr(module, plain)))
        monkeypatch.setattr(module, bf16, refuse(bf16))
    (fwd_plain, _, _), (bwd_plain, _, _) = fa._IMPLS["bnhd"]
    impls = dict(fa._IMPLS)
    impls["bnhd"] = (
        (fwd_plain, refuse("flash_attention_cuda"),
         spy("flash_attention_f32_cuda", fwd_plain)),
        (bwd_plain, refuse("flash_attention_bwd_cuda"),
         spy("flash_attention_bwd_f32_cuda", bwd_plain)))
    monkeypatch.setattr(fa, "_IMPLS", impls)

    loss, got = _step(config)
    f32 = [f32 for _, _, _, f32 in GEMM_OPS] + [
        "flash_attention_f32_cuda", "flash_attention_bwd_f32_cuda"]
    assert calls == {name: DEPTH for name in f32}
    assert loss == want_loss
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _keep_bits16(bh, n, q, key0, seed, keep_q):
    """flash_f32.cuh keep_bits16 of the sixteen keys key0 .. + 15 of query
    row q (numpy arrays of the same shape): bit j set where byte i0 + j of
    the mask's stream, i0 = (bh N + q) N + key0, is below keep_q; the bytes
    of Philox block i0 / 16 and, where i0 % 16 > 0, of the next."""
    i0 = ((bh * n + q.astype(np.int64)) * n + key0).reshape(-1)
    w0 = nn.philox4x32(torch.from_numpy(i0 >> 4), seed).numpy()
    w1 = nn.philox4x32(torch.from_numpy((i0 >> 4) + 1), seed).numpy()
    bits = np.zeros(i0.size, np.int64)
    for j in range(16):
        e = i0 + j
        words = np.where(((e >> 4) == (i0 >> 4))[:, None], w0, w1)
        byte = (words[np.arange(e.size), (e & 15) >> 2] >> (8 * (e & 3))) \
            & 0xFF
        bits |= (byte < keep_q).astype(np.int64) << j
    return bits.reshape(np.shape(q))


def _k5_walks(q, k, v, o, do, lsum, scale, n_valid, rate, seed):
    """K5 f32's two passes (csrc/flash_attention_bwd_f32.cu) on [1, N, H,
    D] operands, tile by tile in float64: pass 1 a block of 64 query rows
    walking the key tiles of 32 below n_valid, with delta from dO and O
    and l per row; pass 2 a block of 64 keys (zeros at or past n_valid)
    walking every query tile of 32, with l and delta per column staged
    from the [B, H, N] rows (zeros past N, where p is 0). The mask from
    keep_bits16 as the lanes draw it: in pass 1 each row's two 16-key
    halves of the key tile, in pass 2 each query's 16 keys of a warp."""
    _, n, h, d = q.shape
    keep_q, keep = nn.keep_threshold(rate) if rate else (256, 1.0)
    scale_log2 = scale * fa.LOG2E
    ds_scale = scale / keep
    f = [t[0].permute(1, 0, 2).double().numpy() for t in (q, k, v, o, do)]
    l_all = lsum[0].double().numpy()
    dq, dk, dv = (np.zeros((h, n, d)) for _ in range(3))
    delta = np.zeros((h, n))

    def probs(s, qrows, keys, l):
        e = np.exp2(np.clip(s * scale_log2, -fa.SCORE_CAP, fa.SCORE_CAP))
        valid = (keys[None, :] < n_valid) & (qrows[:, None] < n)
        return np.where(valid, e / l, 0.0)

    def mask(hh, qrows, keys):
        """Keep (0/1) of [len(qrows), len(keys)], keys in windows of 16
        (a tile's halves in pass 1, a warp's keys in pass 2)."""
        if not rate:
            return np.ones((len(qrows), len(keys)))
        key0 = keys[::16]
        qq, kk = np.meshgrid(qrows, key0, indexing="ij")
        bits = _keep_bits16(hh, n, qq, kk, seed, keep_q)
        return ((bits[..., None] >> np.arange(16)) & 1).reshape(
            len(qrows), len(keys)).astype(np.float64)

    for hh in range(h):
        qf, kf, vf, of, dof = (t[hh] for t in f)
        qf, kf, vf, of, dof = (np.concatenate([t, np.zeros((64, d))])
                               for t in (qf, kf, vf, of, dof))
        l_row = np.concatenate([l_all[hh], np.zeros(64)])
        # Pass 1.
        for q0 in range(0, n, 64):
            rows = np.arange(q0, q0 + 64)
            dl = keep * (dof[rows] * of[rows]).sum(1)
            delta[hh, q0:q0 + 64] = dl[:min(64, n - q0)]
            l = np.where(rows < n, l_row[rows], 1.0)[:, None]
            acc = np.zeros((64, d))
            for kt in range(-(-n_valid // 32)):
                keys = np.arange(kt * 32, kt * 32 + 32)
                s = qf[rows] @ kf[keys].T
                dp = dof[rows] @ vf[keys].T
                p = probs(s, rows, keys, l)
                m = mask(hh, rows, keys)
                ds = p * (dp * m - dl[:, None]) * ds_scale
                acc += ds @ kf[keys]
            dq[hh, q0:q0 + 64] = acc[:min(64, n - q0)]
        # Pass 2.
        d_row = np.concatenate([delta[hh], np.zeros(64)])
        for k0 in range(0, n, 64):
            keys = np.arange(k0, k0 + 64)
            if k0 >= n_valid:
                continue                     # the block writes zeros
            adk, adv = np.zeros((64, d)), np.zeros((64, d))
            for qt in range(-(-n // 32)):
                rows = np.arange(qt * 32, qt * 32 + 32)
                lj = np.where(rows < n, l_row[rows], 0.0)
                dj = np.where(rows < n, d_row[rows], 0.0)
                st = kf[keys] @ qf[rows].T          # [keys, queries]
                dpt = vf[keys] @ dof[rows].T
                with np.errstate(divide="ignore", invalid="ignore"):
                    pt = probs(st.T, rows, keys, lj[:, None]).T
                m = mask(hh, rows, keys).T
                dst = pt * (dpt * m - dj[None, :]) * ds_scale
                adk += dst @ qf[rows]
                adv += (pt * m) @ dof[rows]
            top = min(64, n - k0)
            dk[hh, k0:k0 + top] = adk[:top]
            dv[hh, k0:k0 + top] = adv[:top] / keep
    return tuple(torch.from_numpy(t).permute(1, 0, 2)[None].float()
                 for t in (dq, dk, dv))


@pytest.mark.parametrize("n,n_valid,rate", [(1001, 1001, 0.1),
                                            (1001, 900, 0.1),
                                            (130, 97, 0.0), (70, 33, 0.5)])
def test_k5_f32_tile_walks_match_plain(n, n_valid, rate):
    """K5 f32's walks (n_valid tiles skipped in pass 1 and key blocks
    past it zero in pass 2, l and delta per column in pass 2, the Philox
    window of 4 keys straddling blocks at N = 1001) give the plain
    backward's dq, dk and dv."""
    rng = np.random.default_rng(n + n_valid)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, n, 2, 16)).astype(np.float32)) for _ in range(4))
    kw = {"scale": 0.25, "n_valid": n_valid, "dropout_rate": rate,
          "seed": 31}
    o, lsum = fa.flash_attention_plain(q, k, v, return_stats=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lsum, **kw)
    got = _k5_walks(q, k, v, o, do, lsum, 0.25, n_valid, rate, 31)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_k5_f32_dropout_bytes_are_keep_mask():
    """keep_bits16 over every 16-key window of every row of [1, 2, 1001,
    1001] that the passes draw (both at key0 = 16 w: pass 1 a lane's half
    32 kt + 16 (lane % 2) of the key tile, pass 2 a warp's keys 64 kt + 16
    warp), equal to nn.keep_mask; at N = 1001 most windows straddle two
    Philox blocks."""
    n, h, rate, seed = 1001, 2, 0.1, 77
    q, _ = nn.keep_threshold(rate)
    want = nn.keep_mask(seed, (1, h, n, n), rate).numpy()[0]
    key0 = np.arange(0, n, 16)
    for hh in range(h):
        qq, kk = np.meshgrid(np.arange(n), key0, indexing="ij")
        bits = _keep_bits16(hh, n, qq, kk, seed, q)
        got = ((bits[..., None] >> np.arange(16)) & 1).reshape(n, -1)[:, :n]
        np.testing.assert_array_equal(got.astype(bool), want[hh])
