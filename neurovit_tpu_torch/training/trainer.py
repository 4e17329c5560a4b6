"""Trainer: the ViT's and the ResNet's train and eval loops, 3D and 4D, on
one device or data-parallel over the ranks of a process group.

Counterpart of ``neurovit_tpu/training/trainer.py`` (the reference's
``src/Trainer.py``), on the fused kernels:

- each step draws its dropout seed from a ``torch.Generator`` seeded
  ``TRAINING_SEED + 1`` (the JAX trainer's ``rng`` key, trainer.py:178),
  runs the model with ``train=True``, the masked mean CE of the valid rows
  (trainer.py:52-62), the backward through the kernels' ``autograd``
  functions and an AdamW step (``optim.Optimizer``: schedules, gradient
  accumulation);
- the reference's log lines: every 10% of batches, per-epoch validation,
  ``evaluate_samples`` (trainer.py:556-559, 593-594, 647-648);
- checkpoints each epoch (full train state + the weights pickle) and the
  rolling ``last_model``, the train state's write overlapping the next
  epoch with ``TRAINING_ASYNC_CHECKPOINT`` (trainer.py:423-441; the run's
  exit, ``restore`` and the preempt save wait for it); SIGTERM / SIGINT
  save the train state at the next batch boundary (trainer.py:361-404);
  the plateau schedule (trainer.py:600-613);
- ``TRAINING_PROFILE_STEPS`` = n > 0 traces steps 2 .. 2 + n of epoch 0
  with ``torch.profiler`` into ``GLOBAL_OUTPUT_DIR/profile``
  (trainer.py:524-545); an epoch or a preemption that ends the loop first
  stops the trace there (JAX leaves it running);
- batches go one ahead to the device from pinned memory with
  ``non_blocking`` copies (trainer.py:444-458); the z-major volume layout is
  transposed on the device (trainer.py:227-234); with
  ``TRAINING_HOST_TRANSFER_DTYPE: bf16`` volumes are cast on the host
  (trainer.py:135-147).

The ResNet's BatchNorm running stats move in every micro-step's forward,
as the JAX trainer's ``model_state`` does under ``optax.MultiSteps``; they
are buffers of the model, so the train state, the weight files and
``--resume`` carry them, and eval and ``--inference`` normalize by them.

4D (a ``TRAINING_DIM: 4`` model, trainer.py:101-126, 188-195, 272-310,
460-509): the frozen volume encoder records no graph and is neither
updated nor decayed (the optimizer holds only ``requires_grad``
parameters); sequences are never z-major and are not padded; with
``TRAINING_4D_ENCODER_QUANT: int8`` the encoder's forward runs on an int8
copy of the ViT (``models.vit3d.quantize_blocks`` of a deep copy, made
here and again after ``restore``), outside the model's ``state_dict()``, so
checkpoints keep the f32 encoder; ``TRAINING_4D_FEATURE_CACHE`` trains on
features encoded once (``training.feature_cache``, persisted under
``TRAINING_4D_FEATURE_CACHE_DIR``), drawing the same per-step seeds as the
volume path.

The model's device is the trainer's. The ViT's block kernels K1-K5 and
K7-K9 have f32 instances, so ``TRAINING_PRECISION: f32`` trains a 3D ViT
and a 4D model on either device (a 4D model's int8 encoder too: K10-K13
have f32 instances); the ResNet's pool kernels
take f32 and its convs are cuDNN's, so it trains in f32 on either.

Data parallelism (trainer.py:69-173, 576-634, 680-721 over the JAX mesh's
data axis; ``parallel``): under a process group (``torchrun``, one process
per GPU) the mesh's data axis spans the group, or, on a model axis above
1, each data group of it. ``TRAINING_BATCH_SIZE`` is the global batch;
each data index loads ceil(TRAINING_BATCH_SIZE / data) rows of it through
the loader's strided ``shard=(data index, data)``, the global batch
padded to a multiple of the data axis as JAX pads it (its pad rows repeat
its last volume, label 0, ``valid`` False; the ResNet's BatchNorm counts
them, as JAX's does). The loss is the global masked CE: each rank's sum
over its valid rows divided by the all-reduced valid count, and the
gradients are summed over the data group once per accumulation window,
before the update, so a step is the one-process step. Data index d > 0
folds d into its dropout seed (``sharding.rank_seed``); index 0 keeps the
one-process stream. The logged loss, ``correct`` and ``count`` are sums
over the data group, validation's too, so the plateau schedule reads the
same loss on every rank. The parameters are broadcast from rank 0 at the
start and after a restore. Rank 0 alone writes checkpoints, the rolling
weights, the trace and the log lines, and the ranks meet at a barrier
after each write; a preemption signal on any rank stops every rank at the
same batch boundary. A 4D batch is replicated (every rank loads the same
sequences and draws the same dropout), the model splits the folded B·T
stream over the data group (``NeuroEncoder.encode_sequence``) and rank 0's
gradients are broadcast; the ResNet's BatchNorm takes the global batch's
statistics. The steps run inside ``parallel.use_mesh``.

Tensor parallelism (``MESH_MODEL_AXIS > 1``, ``parallel.tensor_parallel``,
trainer.py:163): the ranks of one data index form a model group, and each
holds its shard of the ViT, cut from rank 0's whole model at the start and
from the whole weights at a restore (the 4D model's frozen encoder and
its int8 copy, quantized whole, too); AdamW's moments are the shard's. The
gradients each model rank holds in part (the blocks' LayerNorm affines and
row-parallel biases) are summed over the model group before the data
group's sum. Checkpoints, the rolling weights and the weight files are
whole, gathered over the model group: a one-process run restores them. The
ResNet has no tensor-parallel rule and is replicated over the model axis.
Without a process group nothing of this runs, and the steps are the
one-device steps bit for bit.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.data.loader import DataLoader
from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder
from neurovit_tpu_torch.parallel import (create_mesh, sharding,
                                        tensor_parallel, use_mesh)
from neurovit_tpu_torch.parallel.mesh import Mesh
from neurovit_tpu_torch.parallel.sharding import SEED_HIGH
from neurovit_tpu_torch.training import checkpoint as ckpt
from neurovit_tpu_torch.training.metrics import MetricLogger
from neurovit_tpu_torch.training.optim import Optimizer
from neurovit_tpu_torch.utils import profiling

def check_supported(config: Dict[str, Any], device: torch.device) -> None:
    """Raise for values the JAX trainer rejects."""
    # As neurovit_tpu/training/trainer.py:109-112, in 3D too; "int8" acts
    # only on a 4D model.
    quant4d = config.get("TRAINING_4D_ENCODER_QUANT")
    if quant4d not in (None, "", "none", "int8"):
        raise ValueError(f"unknown TRAINING_4D_ENCODER_QUANT {quant4d!r} "
                         "(supported: 'int8')")


class Trainer:
    def __init__(self, config: Dict[str, Any], model: NeuroEncoder,
                 dataset_train, dataset_val, *,
                 logger: Optional[MetricLogger] = None,
                 mesh: Optional[Mesh] = None):
        """``mesh``: default ``create_mesh(config)`` over the default
        process group (one device without one)."""
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        check_supported(config, self.device)
        self.mesh = mesh if mesh is not None else create_mesh(config)
        self._dp = self.mesh.distributed
        self._tp = self._dp and self.mesh.model > 1
        self.rank, world = self.mesh.rank, self.mesh.data
        # 3D batches are split over the data axis; a 4D batch is replicated
        # (trainer.py:576, shard_batch(..., replicate=True)).
        self._shard_rows = self._dp and not model.is_4d
        self._writer = self.rank == 0 and self.mesh.model_index == 0
        self.output_dir = config["GLOBAL_OUTPUT_DIR"]
        self.epochs = config["TRAINING_EPOCHS"]
        self.batch_size = config["TRAINING_BATCH_SIZE"]
        self.num_workers = config.get("TRAINING_NUM_WORKERS", 8)
        # A global batch the data axis does not divide is padded to a
        # multiple of it (trainer.py:711-721): each data index loads its
        # rows of the padded batch.
        self._local_batch = (-(-self.batch_size // world) if self._shard_rows
                             else self.batch_size)
        self._shard = (self.rank, world) if self._shard_rows else None
        self.logger = logger if logger is not None else MetricLogger(config)
        self.data = dataset_train
        self.val_data = dataset_val
        self._preempt_requested = False
        self._seed = seed = config.get("TRAINING_SEED", 42)
        self.dataloader = self._loader_of(dataset_train, shuffle=True)
        self.val_dataloader = self._loader_of(dataset_val, shuffle=False)
        # The preemption flag is summed on the host, over gloo across the
        # world: no device sync at the batch boundary.
        self._host_group = None
        self._params_banner = model.param_count()
        if self._dp:
            world_group = dist.group.WORLD
            self._host_group = (world_group
                                if dist.get_backend(world_group) == "gloo"
                                else dist.new_group(backend="gloo"))
            sharding.broadcast_module(
                model, self.mesh, group=world_group if self._tp else None)

        host_dtype = str(config.get("TRAINING_HOST_TRANSFER_DTYPE",
                                    "f32")).lower()
        if host_dtype not in ("f32", "float32", "bf16", "bfloat16"):
            raise ValueError(
                f"unknown TRAINING_HOST_TRANSFER_DTYPE {host_dtype!r} "
                "(supported: 'f32', 'bf16')")
        self._host_bf16 = host_dtype in ("bf16", "bfloat16")
        if (self._host_bf16
                and config.get("TRAINING_PRECISION", "bf16") != "bf16"):
            raise ValueError(
                "TRAINING_HOST_TRANSFER_DTYPE: bf16 requires "
                "TRAINING_PRECISION: bf16 (with f32 compute the host cast "
                "would lose precision the device path keeps)")

        # TRAINING_4D_ENCODER_QUANT: int8 (trainer.py:109-126): the frozen
        # encoder's forward on an int8 copy; the model keeps its weights.
        self._quant4d = (config.get("TRAINING_4D_ENCODER_QUANT") == "int8"
                         and model.is_4d)
        if self._quant4d and model.encoder_kind != "vit":
            raise ValueError("TRAINING_4D_ENCODER_QUANT supports the ViT "
                             "volume encoder only")
        self._q8_encoder = self._quantized_encoder()
        if self._tp:
            # Megatron-style tensor parallelism: this process's shard of
            # the ViT, cut from rank 0's whole model (and its int8 copy,
            # quantized whole, above).
            tensor_parallel.shard_model_(model, self.mesh)
        self._use_feature_cache = (bool(config.get(
            "TRAINING_4D_FEATURE_CACHE", False)) and model.is_4d)
        self._feature_cache = None

        self.optimizer = Optimizer(config, model.parameters(),
                                   steps_per_epoch=max(1, len(self.dataloader)))
        if self._dp:
            self.optimizer.before_update = self._reduce_grads
        self._plateau = config.get("TRAINING_LR_SCHEDULE") == "plateau"
        self._plateau_patience = config.get("TRAINING_PLATEAU_PATIENCE", 1)
        self._plateau_factor = config.get("TRAINING_PLATEAU_FACTOR", 0.5)
        self._plateau_best = float("inf")
        self._plateau_bad_epochs = 0
        # The dropout seed stream: one 63-bit seed per micro-batch.
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.epoch = 0

        self.log_interval = max(1, len(self.dataloader) // 10)  # Trainer.py:34
        total, trainable = self._params_banner
        self._print(f"Model total parameters: {total/1e6:.2f}M "
                    f"(trainable {trainable/1e6:.2f}M and frozen "
                    f"{(total-trainable)/1e6:.2f}M)")
        self._print(f"Number of batches training: {len(self.dataloader)} "
                    f"of size {self.batch_size}")
        self._print(f"Number of batches validation: "
                    f"{len(self.val_dataloader)} of size {self.batch_size}")
        self._print("=" * 50)

    def _print(self, *args, **kwargs) -> None:
        """print on rank 0; the other ranks stay quiet."""
        if self._writer:
            print(*args, **kwargs)

    def _loader_of(self, dataset, shuffle: bool) -> DataLoader:
        """The loader of this rank's rows (the padded global batch's, when
        the rows are split over the data axis)."""
        return DataLoader(dataset, self._local_batch, shuffle=shuffle,
                          num_workers=self.num_workers, seed=self._seed,
                          shard=self._shard,
                          global_batch=(self.batch_size if self._shard
                                        else None))

    def _quantized_encoder(self, whole=None):
        """The int8 copy of the ViT the 4D encoder runs on, or None: the
        whole ViT (``whole``, default the model's) quantized, then, on a
        model axis above 1, cut to this process's shard."""
        if not self._quant4d:
            return None
        from neurovit_tpu_torch.models.vit3d import quantize_blocks
        vit = quantize_blocks(copy.deepcopy(
            whole if whole is not None else self.model.volume_encoder.vit3d))
        if self._tp:
            vit = tensor_parallel.cut_vit(vit, self.mesh.model_index,
                                          self.mesh.model)
        return vit

    def _reduce_grads(self, params) -> None:
        """Before the update: on a model axis above 1, the gradients each
        model rank holds in part summed over the model group; then every
        gradient summed over the data group (a replicated 4D batch: rank
        0's over the world)."""
        if self._tp:
            tensor_parallel.reduce_partial_grads(self.model, self.mesh)
        sharding.reduce_grads(
            params, self.mesh, replicated=not self._shard_rows,
            group=dist.group.WORLD if self._tp else None)

    def _whole_state(self) -> Dict[str, torch.Tensor]:
        """The model's whole state dict: a sharded model's is gathered over
        the model group (every rank calls this)."""
        if self._tp:
            return tensor_parallel.whole_state_dict(self.model, self.mesh)
        return self.model.state_dict()

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    @staticmethod
    def _model_volume(volume: torch.Tensor, zyx: bool) -> torch.Tensor:
        """[B, X, Y, Z] model input; z-major batches arrive as the raw
        [B, Z, Y, X] buffer and are transposed here, on the device."""
        return volume.permute(0, 3, 2, 1) if zyx else volume

    def train_step(self, batch: Dict[str, torch.Tensor], zyx: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """One micro-batch: forward with dropout, masked CE, backward, and
        the optimizer step when the accumulation window is full, an f32
        model's products at full f32 throughout (``nn.full_f32``). Returns
        device tensors (fetched at the log boundary)."""
        self.model.train()
        seed = int(torch.randint(0, SEED_HIGH, (1,),
                                 generator=self.generator))
        if self._shard_rows:
            seed = sharding.rank_seed(seed, self.rank)
        with nn.full_f32(self.model.compute_dtype), use_mesh(self.mesh):
            logits = self._logits(batch, zyx, train=True, seed=seed)
            loss, correct, count = self._loss(logits, batch)
            loss.backward()
            self.optimizer.step()
        return self._global_metrics(loss.detach(), correct, count)

    def _loss(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """(loss, correct, count) of this rank's rows: the masked mean CE,
        or, with the rows split over the ranks, this rank's share of the
        global masked mean (its sum over the global valid count)."""
        if not self._shard_rows:
            return nn.masked_mean_ce(logits, batch["label"], batch["valid"])
        total, correct, count = nn.masked_ce_sums(logits, batch["label"],
                                                  batch["valid"])
        n = sharding.all_reduce_sum(batch["valid"].float().sum(), self.mesh)
        return total / torch.clamp(n, min=1.0), correct, count

    def _global_metrics(self, loss, correct, count
                        ) -> Dict[str, torch.Tensor]:
        """The step's metrics over the global batch: the ranks' shares of
        the loss and their counts summed, in one all-reduce."""
        if not self._shard_rows:
            return {"loss": loss, "correct": correct, "count": count}
        sums = sharding.all_reduce_sum(
            torch.stack([loss.float(), correct.float(), count.float()]),
            self.mesh)
        return {"loss": sums[0], "correct": sums[1].long(),
                "count": sums[2].long()}

    def _logits(self, batch: Dict[str, torch.Tensor], zyx: bool,
                train: bool = False, seed: Optional[int] = None):
        """The model on a volume batch, or its temporal head on a batch of
        cached [B, T, C] features (they ride the ``volume`` key)."""
        if batch["volume"].dim() == 3:
            return self.model.apply_features(batch["volume"], train=train,
                                             seed=seed)
        return self.model(self._model_volume(batch["volume"], zyx),
                          train=train, seed=seed, encoder=self._q8_encoder)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], zyx: bool = False
                  ) -> Dict[str, torch.Tensor]:
        """The global batch's loss, ``correct`` and ``count``, and this
        rank's rows' predictions."""
        self.model.eval()
        with use_mesh(self.mesh):
            logits = self._logits(batch, zyx)
            loss, correct, count = self._loss(logits, batch)
        return {**self._global_metrics(loss, correct, count),
                "preds": logits.argmax(dim=-1)}

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------

    def _host_batch(self, batch: Dict[str, Any]
                    ) -> Tuple[Dict[str, torch.Tensor], bool]:
        """The arrays the steps consume, as CPU tensors (pinned when the
        device is a GPU). z-major batches ship their raw [B, Z, Y, X]
        buffer (loader.stack_volumes); bf16 host transfer casts it here,
        as it does cached [B, T, C] features (the rounding apply_features'
        cast to the compute dtype would make)."""
        vol = batch["volume"]
        zyx = bool(batch.get("zyx", False)) and not self.model.is_4d
        ship = vol.transpose(0, 3, 2, 1) if zyx else np.asarray(vol,
                                                                np.float32)
        volume = torch.from_numpy(np.ascontiguousarray(ship, np.float32))
        if self._host_bf16:
            volume = volume.to(torch.bfloat16)
        out = {"volume": volume,
               "label": torch.from_numpy(np.asarray(batch["label"], np.int64)),
               "valid": torch.from_numpy(np.asarray(batch["valid"], np.bool_))}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out, zyx

    def _to_device(self, host: Dict[str, torch.Tensor]):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in host.items()}

    def _device_prefetch(self, loader) -> Iterator:
        """Device batches one transfer ahead of the step that reads them."""
        pending = None
        for batch in loader:
            ready = pending
            host, zyx = self._host_batch(batch)
            pending = (self._to_device(host), zyx, batch)
            if ready is not None:
                yield ready
        if pending is not None:
            yield pending

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _checkpoint_state(self) -> Dict[str, Any]:
        """The train state, whole (one process's keys and shapes) on a
        model axis above 1 too; every rank calls this there."""
        optimizer = self.optimizer.state_dict()
        if self._tp:
            optimizer = {**optimizer,
                         "adamw": tensor_parallel.whole_optimizer_state(
                             optimizer["adamw"], self.model, self.mesh)}
        return {"model": self._whole_state(),
                "optimizer": optimizer,
                "epoch": self.epoch,
                "generator": self.generator.get_state(),
                "plateau": {"best": self._plateau_best,
                            "bad": self._plateau_bad_epochs}}

    def restore(self, path: str) -> None:
        """Resume: weights, optimizer, epoch, the dropout seed stream and the
        plateau counters."""
        ckpt.wait_for_async_saves()   # never read a still-writing checkpoint
        self._barrier()               # nor one rank 0 is still writing
        state = ckpt.load_train_state(path)
        whole = None
        if self._tp:
            tensor_parallel.load_whole_state_dict(self.model, state["model"],
                                                  self.mesh)
            state["optimizer"]["adamw"] = tensor_parallel.cut_optimizer_state(
                state["optimizer"]["adamw"], self.model, self.mesh)
            if self._quant4d:
                whole = self._whole_vit(state["model"])
        else:
            self.model.load_state_dict(state["model"])
        if self._dp:
            sharding.broadcast_module(self.model, self.mesh)
        self._q8_encoder = self._quantized_encoder(whole)
        self._feature_cache = None       # encoded again from these weights
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["epoch"])
        self.generator.set_state(state["generator"])
        if self._plateau:
            self._plateau_best = float(state["plateau"]["best"])
            self._plateau_bad_epochs = int(state["plateau"]["bad"])

    def _whole_vit(self, state: Dict[str, torch.Tensor]):
        """A whole ViT of the model's config holding the ViT weights of a
        whole state dict."""
        from neurovit_tpu_torch.models.vit3d import ViT3D
        from neurovit_tpu_torch.training.state_dict import PREFIX
        vit = ViT3D(self.model.vit_cfg, device="meta").to_empty(
            device=self.device)
        vit.load_state_dict({k[len(PREFIX):]: v for k, v in state.items()
                             if k.startswith(PREFIX)})
        return vit

    def request_preempt(self, *_args) -> None:
        """Checkpoint and stop at the next batch boundary (signal-safe)."""
        self._preempt_requested = True

    def _install_preempt_handlers(self):
        """SIGTERM/SIGINT -> request_preempt for the duration of run();
        returns the callback that restores the previous handlers. A second
        signal falls through to the original handler."""
        if not self.config.get("TRAINING_PREEMPTION_SAVE", True):
            return lambda: None
        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        previous = {}

        def handler(sig, _frame):
            self.request_preempt()
            signal.signal(sig, previous[sig])
            print(f"Signal {sig}: saving train state at the next batch "
                  f"boundary (repeat to force-stop)")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

        def restore():
            for sig, old in previous.items():
                if signal.getsignal(sig) is handler:
                    signal.signal(sig, old)
        return restore

    def _agree_preempt(self) -> bool:
        """Whether any rank has been asked to stop; every rank then stops
        at this boundary."""
        if self._dp:
            flag = torch.tensor([float(self._preempt_requested)])
            dist.all_reduce(flag, group=self._host_group)
            self._preempt_requested = bool(flag.item() > 0)
        return self._preempt_requested

    def _barrier(self) -> None:
        if self._dp:
            dist.barrier(group=self._host_group)

    def _save(self, path: str, asynchronous: bool = False) -> None:
        """The train state at ``path``, written by rank 0; every rank
        leaves once it is written (or, asynchronously, handed over)."""
        if self._writer or self._tp:
            state = self._checkpoint_state()
        if self._writer:
            ckpt.save_train_state(path, state, state["model"],
                                  asynchronous=asynchronous)
        self._barrier()

    def _maybe_preempt_save(self, path: str) -> bool:
        if not self._agree_preempt():
            return False
        save_path = os.path.join(path, "model-preempt")
        ckpt.wait_for_async_saves()
        self._save(save_path)
        self._print(f"PREEMPTED: train state saved to .{save_path}  "
                    f"(resume with --resume {save_path})")
        return True

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def run(self) -> None:
        timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        path = f"{self.output_dir}/{timestamp}"
        if self._writer:
            os.makedirs(path, exist_ok=True)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "plain PyTorch")
        self._print(f"Running on device: {self.device} ({name})")
        backend = (dist.get_backend(self.mesh.group) if self._dp
                   else "one process")
        self._print(f"Running on mesh: {self.mesh.shape} ({backend})")
        restore_handlers = self._install_preempt_handlers()
        try:
            for epoch in range(self.epoch, self.epochs):
                self.train(epoch)
                if self._maybe_preempt_save(path):
                    return
                self.validate(epoch)
                self.epoch = epoch + 1
                self._save(os.path.join(path, f"model-e{epoch}"),
                           asynchronous=bool(self.config.get(
                               "TRAINING_ASYNC_CHECKPOINT", False)))
                weights = self._whole_state()
                if self._writer:
                    ckpt.save_last_model(weights)
                self._print(f"MODEL SAVED to .{path}/model-e{epoch}")
                if self._agree_preempt():
                    self._print(f"PREEMPTED: exiting after epoch {epoch} "
                                "save")
                    return
        finally:
            ckpt.wait_for_async_saves()
            restore_handlers()

    def _ensure_feature_cache(self) -> None:
        """Build the 4D feature cache and its loaders on first use
        (trainer.py:460-515). With ``TRAINING_4D_FEATURE_CACHE_DIR`` each
        split's view is persisted under its fingerprint and reloaded when
        the fingerprint matches; otherwise it is encoded again. In data
        parallelism every rank encodes the whole corpus (the model splits
        each batch's stream over them), rank 0 alone writes the files, and
        the other ranks read them after a barrier."""
        if not self._use_feature_cache or self._feature_cache is not None:
            return
        from neurovit_tpu_torch.training import feature_cache
        cache_dir = self.config.get("TRAINING_4D_FEATURE_CACHE_DIR")
        views = {}
        for split, ds in (("train", self.data), ("val", self.val_data)):
            path = fp = None
            if cache_dir:
                if self._writer:
                    os.makedirs(cache_dir, exist_ok=True)
                path = os.path.join(cache_dir, f"feats_{split}.npz")
                encoder = self.model.frozen_encoder
                fp = feature_cache.fingerprint(
                    tensor_parallel.whole_state_dict(encoder, self.mesh)
                    if self._tp else encoder, self._quant4d, ds)
                self._barrier()   # every rank looks before rank 0 writes
                views[split] = feature_cache.load_view(path, fp)
                self._barrier()
                if views[split] is not None:
                    self._print(f"[4D FEATURE CACHE] loaded persisted "
                                f"{split} cache ({len(views[split])} "
                                f"sequences, fingerprint {fp})")
                    continue
            with use_mesh(self.mesh):
                views[split] = feature_cache.precompute(
                    self.model, ds, batch_size=self.batch_size,
                    num_workers=self.num_workers, host_bf16=self._host_bf16,
                    encoder=self._q8_encoder, quiet=not self._writer)
            if path:
                if self._writer:
                    feature_cache.save_view(path, views[split], fp)
                self._barrier()
                if not self._writer:
                    views[split] = feature_cache.load_view(path, fp)
        self._feature_cache = views
        self._feat_dataloader = self._loader_of(views["train"], shuffle=True)
        self._feat_val_dataloader = self._loader_of(views["val"],
                                                    shuffle=False)

    def _loader(self, train: bool):
        """The cached features' loader once the cache is built, else the
        volumes'."""
        self._ensure_feature_cache()
        if self._feature_cache is not None:
            return (self._feat_dataloader if train
                    else self._feat_val_dataloader)
        return self.dataloader if train else self.val_dataloader

    def train(self, epoch: int) -> None:
        loader = self._loader(train=True)
        loader.set_epoch(epoch)
        running: list = []
        start_time = time.time()
        profile_steps = (int(self.config.get("TRAINING_PROFILE_STEPS", 0)
                             or 0) if epoch == 0 else 0)
        with contextlib.ExitStack() as window:
            for i, (batch, zyx, _) in enumerate(
                    self._device_prefetch(loader)):
                if self._agree_preempt():
                    break                # run() saves the preempt state
                if profile_steps and i == 2 and self._writer:
                    window.enter_context(profiling.trace(
                        os.path.join(self.output_dir, "profile"),
                        cuda=self.device.type == "cuda"))
                running.append(self.train_step(batch, zyx))
                if profile_steps and i == 2 + profile_steps:
                    window.close()
                    profile_steps = 0
                if i != 0 and i % self.log_interval == 0:
                    self._log_train(epoch, i, running, start_time)
                    running = []
                    start_time = time.time()

    def _log_train(self, epoch: int, i: int, running: list,
                   start_time: float) -> None:
        """The reference's line every 10% of batches, over the window's
        steps."""
        avg_loss = round(float(np.mean([float(m["loss"]) for m in running])),
                         5)
        correct = float(sum(int(m["correct"]) for m in running))
        total = float(sum(int(m["count"]) for m in running))
        accuracy = round(correct / max(total, 1), 5)
        lr = round(self.optimizer.current_lr(), 5)
        duration = time.time() - start_time
        self._print(f"epoch {epoch}\t| batch {i}/{len(self.dataloader)}\t| "
                    f"train_loss: {avg_loss:.5f}\t| train_accuracy: "
                    f"{accuracy:.5f}\t| learning_rate: {lr:.5f}\t| "
                    f"duration: {duration:.2f}s")
        self.logger.log({"epoch": epoch, "batch": i, "train_loss": avg_loss,
                         "train_accuracy": accuracy, "learning_rate": lr,
                         "duration": duration})

    def validate(self, epoch: int) -> None:
        loader = self._loader(train=False)
        losses, correct, total = [], 0.0, 0.0
        i = -1
        for i, (batch, zyx, _) in enumerate(
                self._device_prefetch(loader)):
            m = self.eval_step(batch, zyx)
            losses.append(float(m["loss"]))
            correct += float(m["correct"])
            total += float(m["count"])
        avg_val_loss = round(float(np.mean(losses)), 5)
        self.val_loss = avg_val_loss
        accuracy = round(correct / max(total, 1), 5)
        self._print(f"[VALIDATION] epoch {epoch}\t| total_batch {i}\t| "
                    f"val_loss {avg_val_loss:.5f}\t| val_accuracy "
                    f"{accuracy:.5f}")
        self.logger.log({"epoch": epoch, "val_loss": avg_val_loss,
                         "val_accuracy": accuracy})
        if self._plateau:
            self._plateau_step(avg_val_loss)

    def _plateau_step(self, val_loss: float) -> None:
        """Halve the LR after `patience` epochs without val_loss improvement."""
        if val_loss < self._plateau_best - 1e-8:
            self._plateau_best = val_loss
            self._plateau_bad_epochs = 0
            return
        self._plateau_bad_epochs += 1
        if self._plateau_bad_epochs > self._plateau_patience:
            new_lr = self.optimizer.current_lr() * self._plateau_factor
            self.optimizer.set_lr(new_lr)
            self._plateau_bad_epochs = 0
            self._print(f"[LR PLATEAU] reducing learning rate to "
                        f"{new_lr:.6f}")

    def evaluate_samples(self) -> float:
        """Inference sweep over the validation set (Trainer.py:120-166).
        With the rows split over the ranks, the predictions, labels and
        subjects are gathered in the global batch's order; rank 0 prints."""
        self._print("=" * 50)
        self._print(f"Training set has {len(self.data)} samples and "
                    f"validation set has {len(self.val_data)} samples.")
        self._print(f"Training loader has {len(self.dataloader)} batches and "
                    f"validation loader has {len(self.val_dataloader)} "
                    "batches.")
        n_correct, n_total = 0, 0
        wrong_predictions = []
        for batch, zyx, host in self._device_prefetch(self.val_dataloader):
            preds = self.eval_step(batch, zyx)["preds"]
            labels, valid, subjects = host["label"], host["valid"], \
                host["subject"]
            if self._shard_rows:
                preds, labels, valid, subjects = self._gather_rows(
                    preds, batch, subjects)
            preds = preds.cpu().numpy()
            for j in range(len(preds)):
                if not valid[j]:
                    continue
                n_total += 1
                if preds[j] == labels[j]:
                    n_correct += 1
                else:
                    wrong_predictions.append(
                        (subjects[j], int(preds[j]), int(labels[j])))
        accuracy = n_correct / max(n_total, 1)
        self._print(f"Accuracy: {accuracy*100:.2f}%")
        self._print(f"Wrong predictions: {wrong_predictions}")
        return accuracy

    def _gather_rows(self, preds: torch.Tensor,
                     batch: Dict[str, torch.Tensor], subjects: list):
        """Every rank's predictions, labels, valid flags and subjects, in
        the global batch's order (``parallel.sharding.gather_rows``)."""
        rows = sharding.gather_rows(torch.stack(
            [preds.long(), batch["label"].long(), batch["valid"].long()],
            dim=1), self.mesh).cpu().numpy()
        everyone = [None] * dist.get_world_size(self._host_group)
        dist.all_gather_object(everyone, list(subjects),
                               group=self._host_group)
        parts = everyone[::self.mesh.model]      # model index 0's, in order
        ordered = [s for row in zip(*parts) for s in row]
        return (torch.from_numpy(rows[:, 0]), rows[:, 1],
                rows[:, 2].astype(bool), ordered)
