"""The port's data-parallel cases, run by every rank of a gloo group and,
as their reference, by one process without a group.

``tests/test_torch_parallel_ranks.py`` spawns ``world`` ranks
(``torch.multiprocessing``, a ``file://`` rendezvous) that call
:func:`rank_main`; each rank runs every case of :data:`CASES` and saves its
results under the work directory. The test process runs :func:`run_cases`
with no group for the one-process results. This module imports neither
``jax`` nor ``neurovit_tpu``, so the ranks start without them.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from neurovit_tpu_torch.config import load_config
from neurovit_tpu_torch.models import NeuroEncoder
from neurovit_tpu_torch.parallel import (create_mesh, distributed, sharding,
                                        use_mesh)
from neurovit_tpu_torch.training import Trainer

GLOBAL_BATCH = 16
GRID = 20


def overrides(workdir: str, **extra) -> Dict[str, Any]:
    """The tiny f32 config of tests/conftest.py (20^3, patch 5, dim 64,
    depth 2, 4 heads of 16, MLP 128), dropout 0, global batch 16."""
    return {
        "TRAINING_VIT_INPUT_SIZE": GRID, "TRAINING_VIT_PATCH_SIZE": 5,
        "GRADCAM_CUBE_SIZE": 8, "DATASET_NAME": "gradcam",
        "TRAINING_BATCH_SIZE": GLOBAL_BATCH, "TRAINING_EPOCHS": 1,
        "TRAINING_NUM_WORKERS": 2, "TRAINING_DROPOUT": 0.0,
        "TRAINING_PRECISION": "f32", "MODEL_VIT_DIM": 64,
        "MODEL_VIT_DEPTH": 2, "MODEL_VIT_HEADS": 4, "MODEL_VIT_DIM_HEAD": 16,
        "MODEL_VIT_MLP_DIM": 128, "KERNEL_IMPL": "xla",
        "TRAINING_LEARNING_RATE": 1e-3,
        "GLOBAL_OUTPUT_DIR": os.path.join(workdir, "runs"),
        "WANDB_ENABLED": False, **extra}


def tiny_config(workdir: str, **extra) -> Dict[str, Any]:
    return load_config(overrides=overrides(workdir, **extra))


class Volumes:
    """n volumes [20, 20, 20] made from the index; label index % classes."""

    def __init__(self, n: int, classes: int = 8, shape=(GRID,) * 3):
        self.n, self.classes, self.shape = n, classes, shape

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.RandomState(idx)
        return {"volume": rng.randn(*self.shape).astype(np.float32),
                "label": idx % self.classes, "subject": f"s{idx}",
                "timepoint": 0}


class Sequences:
    """n series [20, 20, 20, t] with a bright cube whose place is the
    label (tests/test_torch_train_4d.py's)."""

    def __init__(self, n: int, t: int):
        self.n, self.t = n, t

    def __len__(self):
        return self.n

    def sample(self, idx):
        rng = np.random.RandomState(1000 + idx)
        vol = 0.5 * rng.randn(GRID, GRID, GRID, self.t).astype(np.float32)
        lo = 2 if idx % 2 == 0 else 10
        vol[lo:lo + 8, lo:lo + 8, lo:lo + 8, :] += 3.0
        return {"volume": vol, "label": idx % 2, "subject": f"s{idx}",
                "timepoint": 0}


def global_batches(n: int, b: int = GLOBAL_BATCH, shape=(GRID,) * 3,
                   classes: int = 8, n_valid=None) -> list:
    """n global batches made from seed 7; ``n_valid`` rows of each are
    valid (all by default)."""
    rng = np.random.RandomState(7)
    return [{"volume": rng.randn(b, *shape).astype(np.float32),
             "label": rng.randint(0, classes, b).astype(np.int64),
             "valid": np.arange(b) < (b if n_valid is None else n_valid)}
            for _ in range(n)]


def _tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {"volume": torch.from_numpy(np.ascontiguousarray(batch["volume"])),
            "label": torch.from_numpy(np.asarray(batch["label"])).long(),
            "valid": torch.from_numpy(np.asarray(batch["valid"]))}


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(dict(record))


def _trainer(config, dataset, val=None, weights=None, seed=None,
             logger=None) -> Trainer:
    model = NeuroEncoder(config, device="cpu", seed=seed)
    if weights is not None:
        model.load_state_dict(torch.load(weights), strict=True)
    return Trainer(config, model, dataset, val if val is not None else dataset,
                   logger=logger or ListLogger())


def _steps(trainer: Trainer, batches: list) -> Dict[str, Any]:
    """Train steps on this rank's rows of each global batch; the metrics
    of each, the reduced gradients of each window and the state."""
    grads = []
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    reduce = trainer.optimizer.before_update

    def capture(params):
        if reduce is not None:
            reduce(params)
        grads.append({names[id(p)]: p.grad.detach().clone() for p in params})

    trainer.optimizer.before_update = capture
    metrics = []
    mesh = trainer.mesh
    for b in batches:
        local = sharding.local_rows(b, mesh) if trainer._shard_rows else b
        m = trainer.train_step(_tensors(local))
        metrics.append([float(m["loss"]), int(m["correct"]),
                        int(m["count"])])
    return {"metrics": metrics, "grads": grads,
            "state": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()}}


def case_vit(workdir: str) -> Dict[str, Any]:
    """One step of the 3D ViT at global batch 16 from the weights the
    test wrote (the JAX trainer's init)."""
    config = tiny_config(workdir)
    trainer = _trainer(config, Volumes(64),
                       weights=os.path.join(workdir, "vit_weights.pt"))
    return _steps(trainer, global_batches(1))


def case_ragged(workdir: str) -> Dict[str, Any]:
    """An epoch through the loaders over 27 volumes at global batch 16:
    the last batch has 11 valid rows, so the ranks' valid counts differ
    (and the strided shard wraps)."""
    config = tiny_config(workdir)
    trainer = _trainer(config, Volumes(27), val=Volumes(13), seed=3)
    window = []
    step = trainer.train_step

    def record(batch, zyx=False):
        m = step(batch, zyx)
        window.append([float(m["loss"]), int(m["correct"]), int(m["count"])])
        return m

    trainer.train_step = record
    trainer.train(0)
    trainer.validate(0)
    return {"metrics": window, "logged": trainer.logger.records,
            "val_loss": trainer.val_loss,
            "state": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()},
            "accuracy": trainer.evaluate_samples()}


def case_accum(workdir: str) -> Dict[str, Any]:
    """TRAINING_ACCUMULATION_STEP 2: two micro-batches, one update; the
    second batch has 13 valid rows."""
    config = tiny_config(workdir, TRAINING_ACCUMULATION_STEP=2)
    trainer = _trainer(config, Volumes(64), seed=5)
    batches = global_batches(2)
    batches[1]["valid"] = np.arange(GLOBAL_BATCH) < 13
    return _steps(trainer, batches)


def case_resnet(workdir: str) -> Dict[str, Any]:
    """A ResNet-10 step at global batch 8 through global BatchNorm, 5 rows
    valid (the batch statistics over all 8, the ranks' valid counts
    differ); the running statistics are in the state."""
    config = tiny_config(workdir, MODEL_VOLUME_ENCODER="resnet",
                         MODEL_RESNET_DEPTH=10, TRAINING_BATCH_SIZE=8,
                         DATASET_NAME="adni")
    trainer = _trainer(config, Volumes(16, classes=2), seed=2)
    return _steps(trainer, global_batches(1, b=8, classes=2, n_valid=5))


def case_fourd(workdir: str, quant: bool = False) -> Dict[str, Any]:
    """Two 4D steps at B 2 x T 4 (the stream of 8 split over the ranks),
    the second batch with one valid sequence; with ``quant`` on the int8
    encoder."""
    extra = {"TRAINING_4D_ENCODER_QUANT": "int8"} if quant else {}
    config = tiny_config(workdir, TRAINING_DIM=4, DATASET_NAME="adni",
                         TRAINING_BATCH_SIZE=2, MODEL_TEMPORAL_DROPOUT=0.0,
                         **extra)
    trainer = _trainer(config, Sequences(4, 4), seed=4)
    rng = np.random.RandomState(11)
    batches = [{"volume": rng.randn(2, GRID, GRID, GRID, 4).astype(
                    np.float32),
                "label": rng.randint(0, 2, 2).astype(np.int64),
                "valid": np.array([True, i == 0])} for i in range(2)]
    out = _steps(trainer, batches)
    with torch.no_grad():
        x = torch.from_numpy(batches[0]["volume"])
        with use_mesh(trainer.mesh):
            out["enc"] = trainer.model.encode_sequence(
                x, encoder=trainer._q8_encoder)
    return out


def case_fourd_int8(workdir: str) -> Dict[str, Any]:
    return case_fourd(workdir, quant=True)


def case_feature_cache(workdir: str) -> Dict[str, Any]:
    """The 4D feature cache persisted under TRAINING_4D_FEATURE_CACHE_DIR:
    every rank encodes the corpus (each batch's stream split), rank 0
    writes the files, the other ranks read them; then an epoch on the
    cached features."""
    cache = os.path.join(workdir, "feats")
    config = tiny_config(workdir, TRAINING_DIM=4, DATASET_NAME="adni",
                         TRAINING_BATCH_SIZE=2, MODEL_TEMPORAL_DROPOUT=0.0,
                         TRAINING_4D_FEATURE_CACHE=True,
                         TRAINING_4D_FEATURE_CACHE_DIR=cache)
    trainer = _trainer(config, Sequences(4, 4), val=Sequences(2, 4), seed=4)
    trainer.train(0)
    feats = trainer._feature_cache["train"].feats
    return {"feats": torch.from_numpy(np.stack(feats)),
            "files": sorted(os.listdir(cache)),
            "state": {k: v.clone() for k, v in
                      trainer.model.state_dict().items()}}


def case_restore(workdir: str) -> Dict[str, Any]:
    """A step, a checkpoint written by rank 0, restored by every rank into
    a trainer of other weights; then a step of each."""
    config = tiny_config(workdir)
    path = os.path.join(workdir, "restore", "state")
    first = _trainer(config, Volumes(64), seed=6)
    b1, b2 = global_batches(2)
    _steps(first, [b1])
    first._save(path)
    files = sorted(os.listdir(os.path.dirname(path)))
    other = _trainer(config, Volumes(64), seed=9)
    other.restore(path)
    restored = {k: v.clone() for k, v in other.model.state_dict().items()}
    want = _steps(first, [b2])
    got = _steps(other, [b2])
    return {"restored": restored, "files": files, "after": got["state"],
            "want": want["state"], "metrics": got["metrics"]}


def case_dropout(workdir: str) -> Dict[str, Any]:
    """The dropout seed each rank's train step draws from."""
    config = tiny_config(workdir, TRAINING_DROPOUT=0.1)
    trainer = _trainer(config, Volumes(64), seed=8)
    seeds = []
    logits = trainer._logits

    def spy(batch, zyx, train=False, seed=None):
        seeds.append(seed)
        return logits(batch, zyx, train=train, seed=seed)

    trainer._logits = spy
    _steps(trainer, global_batches(1))
    return {"seeds": seeds}


def case_preempt(workdir: str) -> Dict[str, Any]:
    """The last rank asks to stop after the second step of run(): every
    rank stops at that boundary, and one train state is written."""
    config = tiny_config(workdir, TRAINING_EPOCHS=2)
    trainer = _trainer(config, Volumes(64), seed=10)
    steps = []
    step = trainer.train_step

    def counted(batch, zyx=False):
        steps.append(len(steps))
        if len(steps) == 2 and trainer.rank == trainer.mesh.data - 1:
            trainer.request_preempt()
        return step(batch, zyx)

    trainer.train_step = counted
    trainer.run()
    if dist.is_initialized():      # every rank looks once rank 0 is done
        dist.barrier()
    root = config["GLOBAL_OUTPUT_DIR"]
    saved = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, files in os.walk(root) for f in files)
    return {"steps": len(steps), "saved": saved}


def case_batch_refusal(workdir: str) -> Dict[str, Any]:
    """A global batch of 15 over the ranks, which JAX pads to a multiple of
    the data axis: the refusal's message (None now that it is accepted),
    and a step on this rank's rows of the padded batch."""
    config = tiny_config(workdir, TRAINING_BATCH_SIZE=15)
    try:
        trainer = _trainer(config, Volumes(64), seed=12)
    except ValueError as e:
        return {"error": str(e)}
    out = _steps(trainer, global_batches(1, b=15))
    return {"error": None, "metrics": out["metrics"], "state": out["state"],
            "rows": len(sharding.local_rows(global_batches(1, b=15)[0],
                                            trainer.mesh)["valid"])}


# ---------------------------------------------------------------------------
# Tensor parallelism: dp 2 x tp 2 over four ranks (MESH_MODEL_AXIS 2)
# ---------------------------------------------------------------------------

TP = {"MESH_MODEL_AXIS": 2}


def _tp_steps(trainer: Trainer, batches: list) -> Dict[str, Any]:
    """_steps on a tensor-parallel trainer, its gradients and state
    gathered whole (a one-process model's keys and shapes)."""
    from neurovit_tpu_torch.parallel import tensor_parallel
    out = _steps(trainer, batches)
    out["grads"] = [{k: tensor_parallel.gather(v, k, trainer.mesh)
                     for k, v in window.items()} for window in out["grads"]]
    out["state"] = {k: v.clone() for k, v in trainer._whole_state().items()}
    return out


def case_tp_vit(workdir: str, precision: str = "f32",
                batch: int = GLOBAL_BATCH) -> Dict[str, Any]:
    """One step of the 3D ViT on dp 2 x tp 2 from the JAX trainer's init:
    the whole gradients and parameters, each rank's shard shapes."""
    config = tiny_config(workdir, TRAINING_PRECISION=precision,
                         TRAINING_BATCH_SIZE=batch, **TP)
    trainer = _trainer(config, Volumes(64),
                       weights=os.path.join(workdir, "vit_weights.pt"))
    out = _tp_steps(trainer, global_batches(1, b=batch))
    out["mesh"] = (trainer.mesh.rank, trainer.mesh.model_index,
                   trainer.mesh.data, trainer.mesh.model)
    out["shard"] = {k: tuple(v.shape) for k, v in
                    trainer.model.state_dict().items()}
    return out


def case_tp_vit_bf16(workdir: str) -> Dict[str, Any]:
    return case_tp_vit(workdir, precision="bf16")


def case_tp_vit_pad(workdir: str) -> Dict[str, Any]:
    """A global batch of 5 over the data axis of 2: padded to 6."""
    return case_tp_vit(workdir, batch=5)


def case_tp_resnet_pad(workdir: str) -> Dict[str, Any]:
    """A ResNet-10 step at global batch 5 on dp 2 x tp 2: replicated over
    the model axis, the batch padded to 6, whose pad row the global
    BatchNorm counts as JAX's does."""
    config = tiny_config(workdir, MODEL_VOLUME_ENCODER="resnet",
                         MODEL_RESNET_DEPTH=10, TRAINING_BATCH_SIZE=5,
                         DATASET_NAME="adni", **TP)
    trainer = _trainer(config, Volumes(16, classes=2), seed=2)
    return _steps(trainer, global_batches(1, b=5, classes=2))


def case_tp_fourd(workdir: str, quant: bool = False) -> Dict[str, Any]:
    """case_fourd on dp 2 x tp 2: the frozen encoder tensor-parallel, the
    B·T stream of 8 split over the data axis."""
    extra = {"TRAINING_4D_ENCODER_QUANT": "int8"} if quant else {}
    config = tiny_config(workdir, TRAINING_DIM=4, DATASET_NAME="adni",
                         TRAINING_BATCH_SIZE=2, MODEL_TEMPORAL_DROPOUT=0.0,
                         **TP, **extra)
    trainer = _trainer(config, Sequences(4, 4), seed=4)
    rng = np.random.RandomState(11)
    batches = [{"volume": rng.randn(2, GRID, GRID, GRID, 4).astype(
                    np.float32),
                "label": rng.randint(0, 2, 2).astype(np.int64),
                "valid": np.array([True, i == 0])} for i in range(2)]
    return _tp_steps(trainer, batches)


def case_tp_fourd_int8(workdir: str) -> Dict[str, Any]:
    return case_tp_fourd(workdir, quant=True)


def case_tp_dropout(workdir: str) -> Dict[str, Any]:
    """A step at dropout 0.1 on dp 2 x tp 2: the key of every dropout site
    of the blocks (the column-parallel probabilities and hidden, the
    row-parallel out-projection and MLP output) and the embedding's."""
    from neurovit_tpu_torch.ops import tp_forms
    from neurovit_tpu_torch.parallel import tensor_parallel
    config = tiny_config(workdir, TRAINING_DROPOUT=0.1, **TP)
    trainer = _trainer(config, Volumes(64), seed=8)
    keys = {"probs": [], "hidden": [], "outproj": [], "mlp_out": [],
            "step": []}
    attend, outproj, mlp = (tensor_parallel.flash_attention,
                            tp_forms.outproj_partial, tp_forms.mlp_partial)

    def spy_attend(*args, **kw):
        keys["probs"].append(kw["seed"])
        return attend(*args, **kw)

    def spy_outproj(*args, **kw):
        keys["outproj"].append(kw["seed"])
        return outproj(*args, **kw)

    def spy_mlp(*args, **kw):
        keys["hidden"].append(kw["seeds"][0])
        keys["mlp_out"].append(kw["seeds"][1])
        return mlp(*args, **kw)

    logits = trainer._logits

    def spy_logits(batch, zyx, train=False, seed=None):
        keys["step"].append(seed)
        return logits(batch, zyx, train=train, seed=seed)

    trainer._logits = spy_logits
    tensor_parallel.flash_attention = spy_attend
    tp_forms.outproj_partial = spy_outproj
    tp_forms.mlp_partial = spy_mlp
    try:
        out = _tp_steps(trainer, global_batches(1))
    finally:
        tensor_parallel.flash_attention = attend
        tp_forms.outproj_partial, tp_forms.mlp_partial = outproj, mlp
    return {"keys": keys, "mesh": (trainer.mesh.rank,
                                   trainer.mesh.model_index),
            "loss": out["metrics"][0][0]}


def case_tp_restore(workdir: str) -> Dict[str, Any]:
    """A step on dp 2 x tp 2, the train state written whole by rank 0,
    restored by every rank into a trainer of other weights; then a step of
    each."""
    config = tiny_config(workdir, **TP)
    path = os.path.join(workdir, "tp_restore", "state")
    first = _trainer(config, Volumes(64), seed=6)
    b1, b2 = global_batches(2)
    _tp_steps(first, [b1])
    first._save(path)
    files = sorted(os.listdir(os.path.dirname(path)))
    other = _trainer(config, Volumes(64), seed=9)
    other.restore(path)
    restored = {k: v.clone() for k, v in other._whole_state().items()}
    moments = other.optimizer.opt.state_dict()["state"]
    want = _tp_steps(first, [b2])
    got = _tp_steps(other, [b2])
    return {"restored": restored, "files": files, "path": path,
            "after": got["state"], "want": want["state"],
            "metrics": got["metrics"],
            "moment_shapes": sorted(tuple(st["exp_avg"].shape)
                                    for st in moments.values())}


def case_tp_dryrun(workdir: str) -> Dict[str, Any]:
    """dryrun_multichip(4) on this group: rank 0's printed lines."""
    import contextlib
    import io
    from neurovit_tpu_torch.dryrun import dryrun_multichip
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(dist.get_world_size(), device="cpu")
    return {"lines": [line for line in text.getvalue().splitlines()
                      if line.startswith("dryrun_multichip")]}


TP_CASES = {"tp_vit": case_tp_vit, "tp_vit_bf16": case_tp_vit_bf16,
            "tp_vit_pad": case_tp_vit_pad,
            "tp_resnet_pad": case_tp_resnet_pad, "tp_fourd": case_tp_fourd,
            "tp_fourd_int8": case_tp_fourd_int8,
            "tp_dropout": case_tp_dropout, "tp_restore": case_tp_restore,
            "tp_dryrun": case_tp_dryrun}


def tp_rank_main(rank: int, world: int, workdir: str) -> None:
    """A rank of the dp 2 x tp 2 group: every tensor-parallel case."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        assert distributed.maybe_initialize({}, torch.device("cpu"))
        torch.manual_seed(0)
        root = os.path.join(workdir, "ranks")
        results = {name: case(root) for name, case in TP_CASES.items()}
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


CASES = {"vit": case_vit, "ragged": case_ragged, "accum": case_accum,
         "resnet": case_resnet, "fourd": case_fourd,
         "fourd_int8": case_fourd_int8, "feature_cache": case_feature_cache,
         "restore": case_restore,
         "dropout": case_dropout, "preempt": case_preempt,
         "batch_refusal": case_batch_refusal}


def run_cases(workdir: str, names=None) -> Dict[str, Any]:
    torch.manual_seed(0)
    return {name: CASES[name](workdir) for name in (names or CASES)}


def rank_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        assert distributed.maybe_initialize({}, torch.device("cpu"))
        assert create_mesh({}).data == world
        results = run_cases(os.path.join(workdir, "ranks"))
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
