"""The multi-device dry run: the training step over a dp x tp mesh on the
CPU, held to one process's step.

Counterpart of ``__graft_entry__.py:38-302`` (``dryrun_multichip``), its
data- and tensor-parallel parts, with its config (the tiny f32 ViT: 20^3
volumes, patch 5, dim 64, depth 2, 4 heads of 16, MLP 128, global batch
2 n, an accumulation window of 2), its oracle (the same steps on a
one-process mesh from the same weights and batches) and its bounds (the
loss within 2e-3 relative, the parameters within 2e-3 relative + 1e-5
absolute; the int8 predictor's probabilities within 1e-5 absolute, labels
equal). JAX provisions a virtual CPU mesh of ``n`` devices; PyTorch runs a
process a device, so :func:`dryrun_multichip` spawns ``n`` ranks (or,
inside a process group of ``n`` ranks, runs on it). The ranks run on the
card, rank r on ``cuda:(r mod the cards)``, over NCCL where each rank has
a card of its own and over gloo where ranks share one (NCCL takes one rank
a card); ``device="cpu"`` (``--device cpu``) runs them on the CPU over
gloo. The model axis is 2 where ``n`` is even.

The parts, each with JAX's summary line: the 3D step; the 4D step (the
frozen encoder tensor-parallel over the model axis, the B·T stream over
the data axis); the int8 predictor on the dp x tp mesh with bucket routing
(rank 0, one process, over ``n`` devices: the ranks' cards, or ``n``
copies of the CPU); the 4D feature cache
over the mesh. JAX's GPipe parts (the 3D-pp step and the composed dp x tp
x pp mesh) wait for ROADMAP.md Queue 1's pipeline item: a line says so,
and they are not run.

    python -m neurovit_tpu_torch.dryrun [n] [--device cpu]   # n: 4
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

LOSS_RTOL = 2e-3
PARAM_RTOL, PARAM_ATOL = 2e-3, 1e-5
PROB_ATOL = 1e-5


def _config(n: int, **extra) -> Dict[str, Any]:
    """JAX's dryrun config (__graft_entry__.py:5-15, 109-129)."""
    from neurovit_tpu_torch.config import load_config
    return load_config(overrides={
        "DATASET_NAME": "gradcam", "TRAINING_VIT_INPUT_SIZE": 20,
        "TRAINING_VIT_PATCH_SIZE": 5, "GRADCAM_CUBE_SIZE": 8,
        "GRADCAM_NUM_SAMPLES": 4 * n + 8, "GRADCAM_TRAIN_PATH": None,
        "GRADCAM_VAL_PATH": None, "TRAINING_DROPOUT": 0.0,
        "MODEL_VIT_DIM": 64, "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4,
        "MODEL_VIT_DIM_HEAD": 16, "MODEL_VIT_MLP_DIM": 128,
        "TRAINING_BATCH_SIZE": 2 * n, "TRAINING_ACCUMULATION_STEP": 2,
        "TRAINING_PRECISION": "f32", "MESH_DATA_AXIS": -1,
        "MESH_MODEL_AXIS": 2 if n % 2 == 0 and n >= 2 else 1,
        "WANDB_ENABLED": False, "TRAINING_NUM_WORKERS": 2, **extra})


class _Sequences:
    """JAX's _Synthetic4D: 4 series [20, 20, 20, t] made from the index."""

    def __init__(self, t: int):
        self.t = t

    def __len__(self):
        return 4

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(20, 20, 20, self.t).astype(np.float32),
                "label": idx % 2, "subject": f"s{idx}", "timepoint": 0}


def _batch(host: Dict[str, Any], device: torch.device
           ) -> Dict[str, torch.Tensor]:
    vol = host["volume"]
    if host.get("zyx"):
        vol = vol.transpose(0, 3, 2, 1)
    out = {"volume": torch.from_numpy(np.ascontiguousarray(vol, np.float32)),
           "label": torch.from_numpy(np.asarray(host["label"], np.int64)),
           "valid": torch.from_numpy(np.asarray(host["valid"], np.bool_))}
    return {k: v.to(device) for k, v in out.items()}


def _hold_params(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                 what: str) -> None:
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key].float().cpu().numpy(), w.float().cpu().numpy(),
            rtol=PARAM_RTOL,
            atol=PARAM_ATOL, err_msg=f"post-update params diverge between "
            f"sharded and single-device training ({what}: {key})")


def _hold_loss(loss: float, loss1: float, what: str) -> None:
    assert np.isfinite(loss), f"non-finite {what} loss {loss}"
    assert abs(loss - loss1) <= LOSS_RTOL * max(1.0, abs(loss1)), (
        f"{what} sharded loss {loss} != single-device loss {loss1}")


def _devices(device: torch.device, n: int) -> list:
    """The ``n`` devices of the dry run: the cards in turn, or the CPU."""
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", r % torch.cuda.device_count())
            for r in range(n)]


def _run(n: int, workdir: str, device: torch.device) -> None:
    """Every part on this rank of a group of ``n``, on ``device``."""
    from neurovit_tpu_torch.data.synthetic import GradCAMDataset
    from neurovit_tpu_torch.models import NeuroEncoder
    from neurovit_tpu_torch.parallel import create_mesh
    from neurovit_tpu_torch.serving import Predictor
    from neurovit_tpu_torch.training import Trainer

    class _Quiet:
        def log(self, _record):
            pass

    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    config = _config(n, GLOBAL_OUTPUT_DIR=os.path.join(workdir, "runs"))
    mesh = create_mesh(config)
    mesh1 = create_mesh({"MESH_DATA_AXIS": -1, "MESH_MODEL_AXIS": 1}, 1)
    ds_train = GradCAMDataset(config, "train")
    ds_val = GradCAMDataset(config, "val")

    def trainers(cfg, train, val):
        """The mesh's trainer and one process's, from one init."""
        return (Trainer(cfg, NeuroEncoder(cfg, device=device), train, val,
                        mesh=mesh, logger=_Quiet()),
                Trainer(cfg, NeuroEncoder(cfg, device=device), train, val,
                        mesh=mesh1, logger=_Quiet()))

    # ---- 3D: two mini-steps, one accumulated update.
    t, t1 = trainers(config, ds_train, ds_val)
    for local, whole in zip(t.dataloader, t1.dataloader):
        m = t.train_step(_batch(local, device))
        m1 = t1.train_step(_batch(whole, device))
        if t.optimizer.steps:
            break
    loss, loss1 = float(m["loss"]), float(m1["loss"])
    _hold_loss(loss, loss1, "3D")
    _hold_params(t._whole_state(), t1.model.state_dict(), "3D")
    say(f"dryrun_multichip({n}): 3D mesh={dict(mesh.shape)} loss={loss:.4f} "
        f"(single-device {loss1:.4f}, params match) OK")
    say(f"dryrun_multichip({n}): 3D-pp (dp x pp2, GPipe) and the composed "
        "dp x tp x pp mesh wait for ROADMAP.md Queue 1's pipeline item; "
        "not run")

    # ---- 4D: the frozen encoder tensor-parallel, the B·T stream over the
    # data axis (B itself is tiny).
    config4d = dict(config, TRAINING_DIM=4, DATASET_NAME="adni",
                    TRAINING_BATCH_SIZE=2)
    seqs = _Sequences(2 * max(1, n // 2))
    t4, t41 = trainers(config4d, seqs, seqs)
    host = _batch(next(iter(t41.dataloader)), device)
    m, m1 = t4.train_step(host), t41.train_step(host)
    loss, loss1 = float(m["loss"]), float(m1["loss"])
    _hold_loss(loss, loss1, "4D")
    _hold_params(t4._whole_state(), t41.model.state_dict(), "4D")
    say(f"dryrun_multichip({n}): 4D mesh={dict(mesh.shape)} loss={loss:.4f} "
        f"(single-device {loss1:.4f}, params match) OK")

    # ---- The int8 predictor on the dp x tp mesh with bucket routing, one
    # process (the JAX server is single-host): rank 0.
    if dist.get_rank() == 0:
        dp, model_axis = mesh.data, mesh.model
        p_mesh = Predictor(NeuroEncoder(config, device=device, seed=7),
                           batch_size=2 * n, quant="int8",
                           bucket_sizes=(dp,), devices=_devices(device, n),
                           model_axis=model_axis)
        assert dp in p_mesh.bucket_sizes
        p_one = Predictor(NeuroEncoder(config, device=device, seed=7),
                          batch_size=2 * n, quant="int8", bucket_sizes=())
        req = np.random.RandomState(0).randn(dp + 1, 20, 20, 20).astype(
            np.float32)
        labels_m, probs_m = p_mesh(req)
        labels_1, probs_1 = p_one(req)
        np.testing.assert_allclose(
            probs_m, probs_1, atol=PROB_ATOL,
            err_msg="int8+bucketed mesh predictor diverges from "
                    "single-device")
        assert (labels_m == labels_1).all()
        say(f"dryrun_multichip({n}): int8 predictor x dp-x-tp mesh x bucket "
            f"routing (buckets {p_mesh.bucket_sizes}) OK")

    # ---- The 4D feature cache under the mesh: precompute and an epoch on
    # the cached features, against one process's cached run.
    config4dc = dict(config4d, TRAINING_4D_FEATURE_CACHE=True)
    tc, tc1 = trainers(config4dc, seqs, seqs)
    tc.train(0)
    tc1.train(0)
    assert tc._feature_cache is not None
    _hold_params(tc._whole_state(), tc1.model.state_dict(), "4D cache")
    say(f"dryrun_multichip({n}): 4D feature cache x mesh (params match "
        "single-device) OK")


def _rank(rank: int, n: int, workdir: str, kind: str) -> None:
    torch.set_num_threads(1)
    backend = "gloo"
    device = torch.device("cpu")
    if kind == "cuda":
        device = _devices(torch.device("cuda"), n)[rank]
        torch.cuda.set_device(device)
        if n <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=n)
    try:
        _run(n, workdir, device)
    finally:
        dist.destroy_process_group()


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on the card, and CUDA is "
                           "not available; pass device='cpu' (--device "
                           "cpu) to run it on the CPU")
    return device


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The dp x tp parts of JAX's dry run over ``n_devices`` ranks, on the
    card unless ``device`` is "cpu": spawned here, or, called by every
    rank of a process group of ``n_devices``, run on it (each rank on its
    own device: the group's ``LOCAL_RANK`` card). Raises where a part does
    not match one process."""
    device = _device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process "
                             f"group of {dist.get_world_size()}")
        if device.type == "cuda" and device.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local % torch.cuda.device_count())
        with tempfile.TemporaryDirectory() as workdir:
            _run(n_devices, workdir, device)
        return
    import torch.multiprocessing as mp
    if device.type == "cuda":
        from neurovit_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load it
    with tempfile.TemporaryDirectory() as workdir:
        mp.spawn(_rank, args=(n_devices, workdir, device.type),
                 nprocs=n_devices)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="JAX's dry run's data- and tensor-parallel parts over "
                    "n ranks, held to one process")
    parser.add_argument("n", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
