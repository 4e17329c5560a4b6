"""Trainer: the ViT's and the ResNet's train and eval loops, 3D and 4D, on
one device.

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
take f32 and its convs are cuDNN's, so it trains in f32 on either. A mesh of more than one device is
not ported yet and raises, naming its ROADMAP item.
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

from neurovit_tpu_torch import nn
from neurovit_tpu_torch.data.loader import DataLoader
from neurovit_tpu_torch.models.neuro_encoder import (NeuroEncoder,
                                                     not_ported)
from neurovit_tpu_torch.training import checkpoint as ckpt
from neurovit_tpu_torch.training.metrics import MetricLogger
from neurovit_tpu_torch.training.optim import Optimizer
from neurovit_tpu_torch.utils import profiling

SEED_HIGH = 2 ** 63 - 1


def check_supported(config: Dict[str, Any], device: torch.device) -> None:
    """Raise for the training options the port does not run yet, and for
    values the JAX trainer rejects."""
    # As neurovit_tpu/training/trainer.py:109-112, in 3D too; "int8" acts
    # only on a 4D model.
    quant4d = config.get("TRAINING_4D_ENCODER_QUANT")
    if quant4d not in (None, "", "none", "int8"):
        raise ValueError(f"unknown TRAINING_4D_ENCODER_QUANT {quant4d!r} "
                         "(supported: 'int8')")
    if (int(config.get("MESH_MODEL_AXIS", 1)) > 1
            or int(config.get("MESH_DATA_AXIS", -1)) not in (-1, 1)):
        raise not_ported("a mesh of more than one device", "multi-GPU")


class Trainer:
    def __init__(self, config: Dict[str, Any], model: NeuroEncoder,
                 dataset_train, dataset_val, *,
                 logger: Optional[MetricLogger] = None):
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        check_supported(config, self.device)
        self.output_dir = config["GLOBAL_OUTPUT_DIR"]
        self.epochs = config["TRAINING_EPOCHS"]
        self.batch_size = config["TRAINING_BATCH_SIZE"]
        self.num_workers = config.get("TRAINING_NUM_WORKERS", 8)
        self.logger = logger if logger is not None else MetricLogger(config)
        self.data = dataset_train
        self.val_data = dataset_val
        self._preempt_requested = False
        seed = config.get("TRAINING_SEED", 42)
        self.dataloader = DataLoader(dataset_train, self.batch_size,
                                     shuffle=True,
                                     num_workers=self.num_workers, seed=seed)
        self.val_dataloader = DataLoader(dataset_val, self.batch_size,
                                         shuffle=False,
                                         num_workers=self.num_workers,
                                         seed=seed)

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
        self._seed = seed
        self._use_feature_cache = (bool(config.get(
            "TRAINING_4D_FEATURE_CACHE", False)) and model.is_4d)
        self._feature_cache = None

        self.optimizer = Optimizer(config, model.parameters(),
                                   steps_per_epoch=max(1, len(self.dataloader)))
        self._plateau = config.get("TRAINING_LR_SCHEDULE") == "plateau"
        self._plateau_patience = config.get("TRAINING_PLATEAU_PATIENCE", 1)
        self._plateau_factor = config.get("TRAINING_PLATEAU_FACTOR", 0.5)
        self._plateau_best = float("inf")
        self._plateau_bad_epochs = 0
        # The dropout seed stream: one 63-bit seed per micro-batch.
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.epoch = 0

        self.log_interval = max(1, len(self.dataloader) // 10)  # Trainer.py:34
        total, trainable = model.param_count()
        print(f"Model total parameters: {total/1e6:.2f}M "
              f"(trainable {trainable/1e6:.2f}M and frozen "
              f"{(total-trainable)/1e6:.2f}M)")
        print(f"Number of batches training: {len(self.dataloader)} "
              f"of size {self.batch_size}")
        print(f"Number of batches validation: {len(self.val_dataloader)} "
              f"of size {self.batch_size}")
        print("=" * 50)

    def _quantized_encoder(self):
        """The int8 copy of the ViT the 4D encoder runs on, or None."""
        if not self._quant4d:
            return None
        from neurovit_tpu_torch.models.vit3d import quantize_blocks
        return quantize_blocks(copy.deepcopy(self.model.volume_encoder.vit3d))

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
        with nn.full_f32(self.model.compute_dtype):
            logits = self._logits(batch, zyx, train=True, seed=seed)
            loss, correct, count = nn.masked_mean_ce(logits, batch["label"],
                                                     batch["valid"])
            loss.backward()
            self.optimizer.step()
        return {"loss": loss.detach(), "correct": correct, "count": count}

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
        self.model.eval()
        logits = self._logits(batch, zyx)
        loss, correct, count = nn.masked_mean_ce(logits, batch["label"],
                                                 batch["valid"])
        return {"loss": loss, "correct": correct, "count": count,
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
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "epoch": self.epoch,
                "generator": self.generator.get_state(),
                "plateau": {"best": self._plateau_best,
                            "bad": self._plateau_bad_epochs}}

    def restore(self, path: str) -> None:
        """Resume: weights, optimizer, epoch, the dropout seed stream and the
        plateau counters."""
        ckpt.wait_for_async_saves()   # never read a still-writing checkpoint
        state = ckpt.load_train_state(path)
        self.model.load_state_dict(state["model"])
        self._q8_encoder = self._quantized_encoder()
        self._feature_cache = None       # encoded again from these weights
        self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["epoch"])
        self.generator.set_state(state["generator"])
        if self._plateau:
            self._plateau_best = float(state["plateau"]["best"])
            self._plateau_bad_epochs = int(state["plateau"]["bad"])

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

    def _maybe_preempt_save(self, path: str) -> bool:
        if not self._preempt_requested:
            return False
        save_path = os.path.join(path, "model-preempt")
        ckpt.wait_for_async_saves()
        ckpt.save_train_state(save_path, self._checkpoint_state(), self.model)
        print(f"PREEMPTED: train state saved to .{save_path}  "
              f"(resume with --resume {save_path})")
        return True

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def run(self) -> None:
        timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        path = f"{self.output_dir}/{timestamp}"
        os.makedirs(path, exist_ok=True)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "plain PyTorch")
        print(f"Running on device: {self.device} ({name})")
        restore_handlers = self._install_preempt_handlers()
        try:
            for epoch in range(self.epoch, self.epochs):
                self.train(epoch)
                if self._maybe_preempt_save(path):
                    return
                self.validate(epoch)
                self.epoch = epoch + 1
                ckpt.save_train_state(
                    os.path.join(path, f"model-e{epoch}"),
                    self._checkpoint_state(), self.model,
                    asynchronous=bool(
                        self.config.get("TRAINING_ASYNC_CHECKPOINT", False)))
                ckpt.save_last_model(self.model)
                print(f"MODEL SAVED to .{path}/model-e{epoch}")
                if self._preempt_requested:
                    print(f"PREEMPTED: exiting after epoch {epoch} save")
                    return
        finally:
            ckpt.wait_for_async_saves()
            restore_handlers()

    def _ensure_feature_cache(self) -> None:
        """Build the 4D feature cache and its loaders on first use
        (trainer.py:460-515). With ``TRAINING_4D_FEATURE_CACHE_DIR`` each
        split's view is persisted under its fingerprint and reloaded when
        the fingerprint matches; otherwise it is encoded again."""
        if not self._use_feature_cache or self._feature_cache is not None:
            return
        from neurovit_tpu_torch.training import feature_cache
        cache_dir = self.config.get("TRAINING_4D_FEATURE_CACHE_DIR")
        views = {}
        for split, ds in (("train", self.data), ("val", self.val_data)):
            path = fp = None
            if cache_dir:
                os.makedirs(cache_dir, exist_ok=True)
                path = os.path.join(cache_dir, f"feats_{split}.npz")
                fp = feature_cache.fingerprint(self.model.frozen_encoder,
                                               self._quant4d, ds)
                views[split] = feature_cache.load_view(path, fp)
                if views[split] is not None:
                    print(f"[4D FEATURE CACHE] loaded persisted {split} "
                          f"cache ({len(views[split])} sequences, "
                          f"fingerprint {fp})")
                    continue
            views[split] = feature_cache.precompute(
                self.model, ds, batch_size=self.batch_size,
                num_workers=self.num_workers, host_bf16=self._host_bf16,
                encoder=self._q8_encoder)
            if path:
                feature_cache.save_view(path, views[split], fp)
        self._feature_cache = views
        self._feat_dataloader = DataLoader(
            views["train"], self.batch_size, shuffle=True,
            num_workers=self.num_workers, seed=self._seed)
        self._feat_val_dataloader = DataLoader(
            views["val"], self.batch_size, shuffle=False,
            num_workers=self.num_workers, seed=self._seed)

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
                if self._preempt_requested:
                    break                # run() saves the preempt state
                if profile_steps and i == 2:
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
        print(f"epoch {epoch}\t| batch {i}/{len(self.dataloader)}\t| "
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
        print(f"[VALIDATION] epoch {epoch}\t| total_batch {i}\t| "
              f"val_loss {avg_val_loss:.5f}\t| val_accuracy {accuracy:.5f}")
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
            print(f"[LR PLATEAU] reducing learning rate to {new_lr:.6f}")

    def evaluate_samples(self) -> float:
        """Inference sweep over the validation set (Trainer.py:120-166)."""
        print("=" * 50)
        print(f"Training set has {len(self.data)} samples and validation set "
              f"has {len(self.val_data)} samples.")
        print(f"Training loader has {len(self.dataloader)} batches and "
              f"validation loader has {len(self.val_dataloader)} batches.")
        n_correct, n_total = 0, 0
        wrong_predictions = []
        for batch, zyx, host in self._device_prefetch(self.val_dataloader):
            preds = self.eval_step(batch, zyx)["preds"].cpu().numpy()
            labels, valid = host["label"], host["valid"]
            for j in range(len(preds)):
                if not valid[j]:
                    continue
                n_total += 1
                if preds[j] == labels[j]:
                    n_correct += 1
                else:
                    wrong_predictions.append(
                        (host["subject"][j], int(preds[j]), int(labels[j])))
        accuracy = n_correct / max(n_total, 1)
        print(f"Accuracy: {accuracy*100:.2f}%")
        print(f"Wrong predictions: {wrong_predictions}")
        return accuracy
