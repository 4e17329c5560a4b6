"""Batched inference serving for NeuroEncoder checkpoints, on the card.

Counterpart of ``neurovit_tpu/serving.py``: a ``Predictor`` loads a
checkpoint once and serves any request size through a fixed set of batch
buckets -- full ``batch_size`` chunks stream through, the tail routes to
the smallest bucket that fits and is padded by repeating its last volume
(the padding is thrown away). A 4D checkpoint serves whole sequences: a
request is [N, H, W, D, T] and a bucket counts sequences.

    predictor = Predictor.from_checkpoint(config, "best_model.pkl")
    labels, probs = predictor(volumes)          # [N, H, W, D] -> [N], [N, C]

Runs on ``device`` (default ``cuda``), which must exist: there is no drop
to the CPU. ``device="cpu"`` asks for the plain PyTorch path explicitly.
``quant="int8"`` serves the int8 blocks (``models.vit3d.quantize_blocks``,
kernels K10-K13, at bf16 or, for an f32 model, their f32 instances),
quantized once when the predictor is built.

``devices=[...]`` serves data-parallel over several devices of this
process (neurovit_tpu/serving.py:40-160): one replica of the model on
each, every bucketed chunk split into equal slices, one a replica. With
``model_axis`` m > 1 (``MESH_MODEL_AXIS``, serving.py:127-143) each
replica is tensor-parallel over m consecutive devices of the list
(``parallel.tensor_parallel.TensorParallelViT``; a device may repeat), at
bf16, f32 and int8. The CLIs' ``--mesh`` builds the list from
``parallel.create_mesh`` over the visible cards; serving stays one
process, as the JAX server is single-host.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import quantize_blocks
from neurovit_tpu_torch.parallel import create_mesh
from neurovit_tpu_torch.training.checkpoint import load_checkpoint

# Latency buckets below batch_size (neurovit_tpu/serving.py:24-36): powers
# of two bound the padding waste of any request at 2x.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: neurovit_tpu_torch serves on the card "
            "and does not drop to the CPU (pass device='cpu' / --device cpu "
            "to run the plain PyTorch path on purpose)")
    return device


class Predictor:
    """Bucketed-batch predictor over a NeuroEncoder on one device.

    ``bucket_sizes``: batch shapes below ``batch_size`` (default
    ``DEFAULT_BUCKETS``); each request chunk routes to the smallest bucket
    that fits and pads only within it. Every bucket gives the same
    probabilities for the same volumes. Pass ``()`` for one shape.

    ``quant="int8"``: post-training int8 serving (neurovit_tpu/serving.py:
    102-124). The model's blocks are quantized in place, once, here; the
    patch embedding, the softmax path and the head stay as they are.

    ``devices``: one replica on each (the model itself on the first,
    copies of it on the others, each quantized once for int8), or, with
    ``model_axis`` m > 1, one tensor-parallel replica on each m of them
    (the ViT quantized whole once for int8, then cut). Each chunk is split
    into equal slices in order, all launched before any is read back.
    Buckets that the replica count (the mesh's data axis) does not divide
    are dropped (with a warning when the caller named them), and a
    ``batch_size`` it does not divide raises, as JAX's mesh Predictor does
    (serving.py:66-83, 129-132)."""

    def __init__(self, model: NeuroEncoder, batch_size: int = 32,
                 host_transfer_dtype: Optional[str] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 quant: Optional[str] = None,
                 devices: Optional[Sequence[Any]] = None,
                 model_axis: int = 1):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        cards = (tuple(torch.device(d) for d in devices) if devices
                 else (self.device,))
        if model_axis < 1 or len(cards) % model_axis:
            raise ValueError(f"MESH_MODEL_AXIS={model_axis} does not divide "
                             f"{len(cards)} devices")
        if model_axis > 1 and model.encoder_kind != "vit":
            raise ValueError("a model axis above 1 serves the ViT volume "
                             "encoder only (the ResNet has no "
                             "tensor-parallel rule)")
        # Each replica's cards; self.devices holds each one's first.
        groups = [cards[i:i + model_axis]
                  for i in range(0, len(cards), model_axis)]
        self.devices = tuple(g[0] for g in groups)
        n_rep = len(self.devices)
        self.batch_size = batch_size
        explicit_buckets = bucket_sizes is not None
        if bucket_sizes is None:
            bucket_sizes = DEFAULT_BUCKETS
        buckets = {int(b) for b in bucket_sizes if 0 < int(b) < batch_size}
        buckets.add(batch_size)
        if n_rep > 1:
            dropped = sorted(b for b in buckets if b % n_rep != 0)
            buckets = {b for b in buckets if b % n_rep == 0} | {batch_size}
            if explicit_buckets and dropped:
                warnings.warn(
                    f"bucket_sizes {dropped} dropped: not multiples of the "
                    f"mesh data axis ({n_rep}); serving with "
                    f"{tuple(sorted(buckets))}", stacklevel=2)
            if batch_size % n_rep != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide over the mesh "
                    f"data axis ({n_rep})")
        self.bucket_sizes = tuple(sorted(buckets))
        # host_transfer_dtype="bf16": volumes cross to the device as bf16 --
        # bit-exact under bf16 compute (the model's first op is the same RNE
        # cast) at half the host->device bytes (neurovit_tpu/serving.py:84-101).
        if host_transfer_dtype in ("none", ""):
            host_transfer_dtype = None
        if host_transfer_dtype not in (None, "bf16", "bfloat16"):
            raise ValueError(
                f"unknown host_transfer_dtype {host_transfer_dtype!r} "
                "(supported: 'bf16')")
        self._host_bf16 = host_transfer_dtype is not None
        if self._host_bf16 and model.compute_dtype != torch.bfloat16:
            raise ValueError(
                "host_transfer_dtype='bf16' requires TRAINING_PRECISION: "
                "bf16 (with f32 compute the host cast would lose precision "
                "the device path keeps)")
        if quant in ("none", ""):
            quant = None
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r} "
                             "(supported: 'int8')")
        self.quant = quant
        if quant == "int8" and model.encoder_kind != "vit":
            raise ValueError("quant='int8' supports the ViT volume "
                             "encoder only")
        if self.device != self.devices[0]:
            self.model = model.to(self.devices[0])
            self.device = self.devices[0]
        if model_axis > 1:
            if quant == "int8":
                quantize_blocks(self.model.volume_encoder.vit3d)
            self.replicas = [_tensor_parallel_replica(self.model, g)
                             for g in groups]
            self.model = self.replicas[0]
            return
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        if quant == "int8":
            for replica in self.replicas:
                quantize_blocks(replica.volume_encoder.vit3d)

    @classmethod
    def from_checkpoint(cls, config: Dict[str, Any], checkpoint_path: str,
                        batch_size: int = 32, seed: Optional[int] = None,
                        host_transfer_dtype: Optional[str] = None,
                        bucket_sizes: Optional[Sequence[int]] = None,
                        device="cuda", quant: Optional[str] = None,
                        devices: Optional[Sequence[Any]] = None,
                        model_axis: int = 1) -> "Predictor":
        """Build the model on ``device`` (or on the first of ``devices``)
        and load a torch-format state dict (the JAX trainer's
        ``.state_dict.pkl`` saves, or ``torch.save``); ``quant="int8"`` then
        quantizes the loaded weights."""
        first = devices[0] if devices else device
        model = NeuroEncoder(config, device=resolve_device(first), seed=seed)
        load_checkpoint(model, checkpoint_path, strict=False)
        return cls(model, batch_size, host_transfer_dtype=host_transfer_dtype,
                   bucket_sizes=bucket_sizes, quant=quant, devices=devices,
                   model_axis=model_axis)

    def _bucket_for(self, remaining: int) -> int:
        """Smallest bucket that fits ``remaining`` (full chunks stream
        through batch_size)."""
        for b in self.bucket_sizes:
            if b >= remaining:
                return b
        return self.batch_size

    def __call__(self, volumes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """volumes [N, H, W, D] (3D) or sequences [N, H, W, D, T] (4D) ->
        (labels [N], probabilities [N, C]).

        At most two chunks are in flight: chunk i+1 is staged in pinned host
        memory, copied without blocking and its forward enqueued before
        chunk i's probabilities are read back, so the host's work overlaps
        the device's. Each chunk's probabilities come back through pinned
        memory behind an event, so reading chunk i does not wait for chunk
        i+1. Softmax is taken in f32. With several replicas the chunk's
        equal slices go to them in order, each launched before any is read
        back."""
        volumes = np.asarray(volumes, np.float32)
        n = volumes.shape[0]
        probs_out = np.empty((n, self.model.num_classes), np.float32)

        def forward(replica, device: torch.device, part: np.ndarray):
            pin = device.type == "cuda"
            host = torch.from_numpy(part)
            if self._host_bf16:
                host = host.to(torch.bfloat16)
            if pin:
                host = host.pin_memory()
            guard = (torch.cuda.device(device) if pin
                     else contextlib.nullcontext())
            with guard, torch.inference_mode():
                logits = replica(host.to(device, non_blocking=True))
                probs = torch.softmax(logits.float(), dim=-1)
                out = torch.empty(probs.shape, dtype=torch.float32,
                                  pin_memory=pin)
                out.copy_(probs, non_blocking=True)
            done = None
            if pin:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
            # ``host`` stays referenced until its copy has been waited on.
            return out, done, host

        def dispatch(start: int):
            bucket = self._bucket_for(n - start)
            chunk = volumes[start:start + bucket]
            real = chunk.shape[0]
            if real < bucket:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bucket - real, axis=0)])
            parts = np.split(chunk, len(self.replicas))
            return start, real, [forward(r, d, p) for r, d, p in zip(
                self.replicas, self.devices, parts)]

        in_flight: deque = deque()
        start = 0
        while start < n or in_flight:
            if start < n and len(in_flight) < 2:
                job = dispatch(start)
                start += job[1]
                in_flight.append(job)
                continue
            s, real, slices = in_flight.popleft()
            for _, done, _ in slices:
                if done is not None:
                    done.synchronize()
            out = torch.cat([o for o, _, _ in slices])
            probs_out[s:s + real] = out[:real].numpy()
        return probs_out.argmax(axis=1), probs_out

    def warmup(self, seq_len: Optional[int] = None) -> None:
        """Run every bucket once ahead of the first request: builds the
        kernels and warms the allocator. A 4D model warms sequences of
        ``seq_len`` timepoints (default 1; pass the deployment's T,
        serving.py:245-252)."""
        base = (self.model.config["TRAINING_VIT_INPUT_SIZE"],) * 3
        if self.model.is_4d:
            base = base + (seq_len if seq_len is not None else 1,)
        for bucket in self.bucket_sizes:
            self(np.zeros((bucket,) + base, np.float32))


def _tensor_parallel_replica(model: NeuroEncoder,
                             cards: Sequence[torch.device]) -> NeuroEncoder:
    """A copy of ``model`` on ``cards[0]`` whose ViT is a tensor-parallel
    replica over ``cards``, cut from the model's (whole) ViT."""
    from torch import nn as tnn
    from neurovit_tpu_torch.parallel.tensor_parallel import TensorParallelViT
    vit = model.volume_encoder.vit3d
    replica = copy.deepcopy(model, {id(vit): tnn.Identity()}).to(cards[0])
    replica.volume_encoder.vit3d = TensorParallelViT(vit, cards)
    return replica.eval()


# --------------------------------------------------------------------------
# Batch-prediction CLI: NIfTI files in -> CSV of predictions out
# --------------------------------------------------------------------------

def _collect_volume_jobs(inputs, crop: bool, sequence: bool = False):
    """Expand inputs (dirs / .nii(.gz) files / a manifest CSV with a
    Path_fMRI_brain column) into (path, timepoint, volume) samples
    (neurovit_tpu/serving.py:261-305).

    3D (default): one [H, W, D] volume per (file, timepoint), with the ADNI
    preprocessing (crop [1:, 10:-9, 1:] + per-volume z-score) when
    ``crop``, else the raw volume z-scored. ``sequence`` (4D checkpoints):
    one whole [H, W, D, T] series per file, cropped on the spatial axes and
    z-scored over the whole 4D array (the 4D dataset's preprocessing),
    yielded as (path, -1, series); a 3D file is a series of T = 1."""
    import glob

    from neurovit_tpu_torch.data import nifti

    paths = []
    for inp in inputs:
        if os.path.isdir(inp):
            paths += sorted(glob.glob(os.path.join(inp, "*.nii"))
                            + glob.glob(os.path.join(inp, "*.nii.gz")))
        elif inp.endswith(".csv"):
            import pandas as pd
            df = pd.read_csv(inp)
            col = next(c for c in ("Path_fMRI_brain", "Path_fMRI", "path")
                       if c in df.columns)
            paths += [p for p in df[col].tolist() if isinstance(p, str)]
        else:
            paths.append(inp)
    for path in paths:
        img = nifti.load(nifti.readable_path(path))
        if sequence:
            box = img.dataobj[1:, 10:-9, 1:] if crop else img.dataobj[...]
            box = np.asarray(box, np.float32)
            if box.ndim == 3:
                box = box[..., None]
            yield path, -1, (box - box.mean()) / (box.std() + 1e-8)
            continue
        n_t = img.shape[3] if len(img.shape) == 4 else 1
        for t in range(n_t):
            box = img.dataobj[..., t] if len(img.shape) == 4 else img.dataobj
            box = np.asarray(box[1:, 10:-9, 1:] if crop else box, np.float32)
            vol = (box - box.mean()) / (box.std() + 1e-8)
            yield path, t, vol


def _prefetch_jobs(jobs, depth: int):
    """Run a (path, t, volume) generator on a producer thread with a
    bounded queue (``depth`` volumes), overlapping NIfTI reads with
    prediction. Producer exceptions re-raise on the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))

    def produce():
        try:
            for item in jobs:
                q.put(item)
            q.put(None)
        except BaseException as e:        # surface to the consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _default_batch_size(is_4d: bool, replicas: int = 1) -> int:
    """Batch when --batch-size is omitted, the JAX CLI's defaults
    (neurovit_tpu/serving.py:336-352): 128 volumes in 3D, 2 sequences in
    4D (each [H, W, D, T] series is 200-400 MB on the host), rounded up to
    a multiple of the mesh's replicas."""
    base = 2 if is_4d else 128
    return -(-base // replicas) * replicas


def predictor_from_cli_args(parser, args, config) -> "Predictor":
    """Shared flag -> Predictor plumbing for the two serving entry points:
    checkpoint resolution (``--checkpoint`` else ``BEST_MODEL_PATH``),
    ``--buckets`` ('' disables, None keeps the default), ``--device``,
    ``--quant``, ``--mesh`` (the mesh of ``create_mesh`` over the visible
    cards of ``--device cuda``: a replica on each, or on each
    ``MESH_MODEL_AXIS`` of them; with ``--device cpu`` one replica on
    ``MESH_MODEL_AXIS`` copies of the CPU) and the default batch size."""
    devices, model_axis = None, 1
    if args.mesh:
        device = resolve_device(args.device)
        visible = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else
                   [device] * int(config.get("MESH_MODEL_AXIS", 1)))
        mesh = create_mesh(config, visible)
        devices, model_axis = mesh.devices, mesh.model
        print(f"Serving over mesh {mesh.shape} on "
              f"{[str(d) for d in devices]}")
    ckpt_path = args.checkpoint or os.path.join(
        config.get("GLOBAL_BASE_PATH", "."), config["BEST_MODEL_PATH"])
    buckets = (() if args.buckets == "" else
               None if args.buckets is None else
               tuple(int(b) for b in args.buckets.split(",")))
    is_4d = int(config.get("TRAINING_DIM", 3)) == 4
    batch_size = (args.batch_size if args.batch_size is not None
                  else _default_batch_size(
                      is_4d, len(devices or [None]) // model_axis))
    return Predictor.from_checkpoint(
        config, ckpt_path, batch_size=batch_size,
        host_transfer_dtype="bf16" if args.host_bf16 else None,
        bucket_sizes=buckets, device=args.device, quant=args.quant,
        devices=devices, model_axis=model_axis)


def add_serving_args(parser) -> None:
    """The flags both entry points share."""
    parser.add_argument("--config", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="torch-format state dict (default: "
                             "BEST_MODEL_PATH)")
    parser.add_argument("--buckets", default=None,
                        help="comma-separated latency buckets below "
                             "--batch-size (default '1,2,4,...,64' powers "
                             "of two); '' disables (single batch shape)")
    parser.add_argument("--quant", default=None, choices=["int8"],
                        help="int8 serving: the ViT blocks' GEMMs and "
                             "attention PV run in int8 (weights quantized "
                             "per channel at load)")
    parser.add_argument("--host-bf16", action="store_true",
                        help="ship volumes to the device as bfloat16 "
                             "(bit-exact under bf16 compute; halves "
                             "host->device bytes)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel serving: one model replica on "
                             "each visible card (tensor-parallel over "
                             "MESH_MODEL_AXIS cards each when it is above "
                             "1), each chunk split over them")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch path)")


def main(argv=None) -> None:
    """``python -m neurovit_tpu_torch.serving``: batch inference over NIfTI
    files -- directories, explicit files or a manifest CSV -- one
    prediction row per (file, timepoint) into --output; a 4D checkpoint
    gives one row per file, its timepoint -1."""
    import argparse
    import csv

    from neurovit_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="NeuroViT batch prediction (PyTorch / CUDA)")
    parser.add_argument("inputs", nargs="+",
                        help=".nii/.nii.gz files, directories, or a "
                             "manifest CSV (Path_fMRI_brain column)")
    parser.add_argument("--output", default="predictions.csv")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="largest batch (default 128; 2 sequences "
                             "for a 4D checkpoint)")
    parser.add_argument("--no-crop", action="store_true",
                        help="skip the ADNI crop [1:, 10:-9, 1:] "
                             "(volumes already at model size)")
    add_serving_args(parser)
    args = parser.parse_args(argv)

    config = load_config(args.config)
    predictor = predictor_from_cli_args(parser, args, config)

    # Stream batch-sized chunks through the predictor: host memory stays
    # bounded at batch_size volumes whatever the manifest's length. A 4D
    # checkpoint serves whole series; series of another T flush first.
    sequence = predictor.model.is_4d
    n_rows = 0
    writer = None
    chunk_meta, chunk_vols = [], []

    def flush(f):
        nonlocal writer, n_rows
        if not chunk_vols:
            return
        labels, probs = predictor(np.stack(chunk_vols))
        if writer is None:
            writer = csv.writer(f)
            writer.writerow(["path", "timepoint", "prediction"]
                            + [f"prob_{c}" for c in range(probs.shape[1])])
        for (path, t), label, p in zip(chunk_meta, labels, probs):
            writer.writerow([path, t, int(label)] + [f"{v:.6f}" for v in p])
        n_rows += len(chunk_meta)
        chunk_meta.clear()
        chunk_vols.clear()

    with open(args.output, "w", newline="") as f:
        jobs = _collect_volume_jobs(args.inputs, crop=not args.no_crop,
                                    sequence=sequence)
        for path, t, vol in _prefetch_jobs(
                jobs, depth=2 if sequence else predictor.batch_size):
            if chunk_vols and vol.shape != chunk_vols[0].shape:
                flush(f)          # a new shape (or T): its own batch
            chunk_meta.append((path, t))
            chunk_vols.append(vol)
            if len(chunk_vols) == predictor.batch_size:
                flush(f)
        flush(f)
    if n_rows == 0:
        os.remove(args.output)
        raise SystemExit("no input volumes found")
    print(f"Wrote {n_rows} predictions to {args.output}")


if __name__ == "__main__":
    main()
