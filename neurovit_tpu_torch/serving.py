"""Batched inference serving for NeuroEncoder checkpoints, on the card.

Counterpart of ``neurovit_tpu/serving.py`` (3D checkpoints): a
``Predictor`` loads a checkpoint once and serves any request size through
a fixed set of batch buckets -- full ``batch_size`` chunks stream through,
the tail routes to the smallest bucket that fits and is padded by
repeating its last volume (the padding is thrown away).

    predictor = Predictor.from_checkpoint(config, "best_model.pkl")
    labels, probs = predictor(volumes)          # [N, H, W, D] -> [N], [N, C]

Runs on ``device`` (default ``cuda``), which must exist: there is no drop
to the CPU. ``device="cpu"`` asks for the plain PyTorch path explicitly.
``quant="int8"`` serves the int8 blocks (``models.vit3d.quantize_blocks``,
kernels K10-K13), quantized once when the predictor is built.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neurovit_tpu_torch.models.neuro_encoder import NeuroEncoder
from neurovit_tpu_torch.models.vit3d import quantize_blocks
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
    patch embedding, the softmax path and the head stay as they are."""

    def __init__(self, model: NeuroEncoder, batch_size: int = 32,
                 host_transfer_dtype: Optional[str] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 quant: Optional[str] = None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        if bucket_sizes is None:
            bucket_sizes = DEFAULT_BUCKETS
        buckets = {int(b) for b in bucket_sizes if 0 < int(b) < batch_size}
        buckets.add(batch_size)
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
        if quant == "int8":
            quantize_blocks(model.volume_encoder.vit3d)

    @classmethod
    def from_checkpoint(cls, config: Dict[str, Any], checkpoint_path: str,
                        batch_size: int = 32, seed: Optional[int] = None,
                        host_transfer_dtype: Optional[str] = None,
                        bucket_sizes: Optional[Sequence[int]] = None,
                        device="cuda", quant: Optional[str] = None
                        ) -> "Predictor":
        """Build the model on ``device`` and load a torch-format state dict
        (the JAX trainer's ``.state_dict.pkl`` saves, or ``torch.save``);
        ``quant="int8"`` then quantizes the loaded weights."""
        model = NeuroEncoder(config, device=resolve_device(device), seed=seed)
        load_checkpoint(model, checkpoint_path, strict=False)
        return cls(model, batch_size, host_transfer_dtype=host_transfer_dtype,
                   bucket_sizes=bucket_sizes, quant=quant)

    def _bucket_for(self, remaining: int) -> int:
        """Smallest bucket that fits ``remaining`` (full chunks stream
        through batch_size)."""
        for b in self.bucket_sizes:
            if b >= remaining:
                return b
        return self.batch_size

    def __call__(self, volumes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """volumes [N, H, W, D] -> (labels [N], probabilities [N, C]).

        At most two chunks are in flight: chunk i+1 is staged in pinned host
        memory, copied without blocking and its forward enqueued before
        chunk i's probabilities are read back, so the host's work overlaps
        the device's. Each chunk's probabilities come back through pinned
        memory behind an event, so reading chunk i does not wait for chunk
        i+1. Softmax is taken in f32."""
        volumes = np.asarray(volumes, np.float32)
        n = volumes.shape[0]
        probs_out = np.empty((n, self.model.num_classes), np.float32)
        pin = self.device.type == "cuda"

        def dispatch(start: int):
            bucket = self._bucket_for(n - start)
            chunk = volumes[start:start + bucket]
            real = chunk.shape[0]
            if real < bucket:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bucket - real, axis=0)])
            host = torch.from_numpy(chunk)
            if self._host_bf16:
                host = host.to(torch.bfloat16)
            if pin:
                host = host.pin_memory()
            with torch.inference_mode():
                logits = self.model(host.to(self.device, non_blocking=True))
                probs = torch.softmax(logits.float(), dim=-1)
                out = torch.empty(probs.shape, dtype=torch.float32,
                                  pin_memory=pin)
                out.copy_(probs, non_blocking=True)
            done = None
            if pin:
                done = torch.cuda.Event()
                done.record()
            # ``host`` stays referenced until its copy has been waited on.
            return start, real, out, done, host

        in_flight: deque = deque()
        start = 0
        while start < n or in_flight:
            if start < n and len(in_flight) < 2:
                job = dispatch(start)
                start += job[1]
                in_flight.append(job)
                continue
            s, real, out, done, _ = in_flight.popleft()
            if done is not None:
                done.synchronize()
            probs_out[s:s + real] = out[:real].numpy()
        return probs_out.argmax(axis=1), probs_out

    def warmup(self) -> None:
        """Run every bucket once ahead of the first request: builds the
        kernels and warms the allocator."""
        base = (self.model.config["TRAINING_VIT_INPUT_SIZE"],) * 3
        for bucket in self.bucket_sizes:
            self(np.zeros((bucket,) + base, np.float32))


# --------------------------------------------------------------------------
# Batch-prediction CLI: NIfTI files in -> CSV of predictions out
# --------------------------------------------------------------------------

def _collect_volume_jobs(inputs, crop: bool):
    """Expand inputs (dirs / .nii(.gz) files / a manifest CSV with a
    Path_fMRI_brain column) into (path, timepoint, volume) samples: one
    [H, W, D] volume per (file, timepoint), with the ADNI preprocessing
    (crop [1:, 10:-9, 1:] + per-volume z-score) when ``crop``, else the raw
    volume z-scored (neurovit_tpu/serving.py:261-305, 3D mode)."""
    import glob

    from neurovit_tpu.data import nifti

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


def _default_batch_size() -> int:
    """Batch when --batch-size is omitted: the JAX CLI's 3D default of 128
    (neurovit_tpu/serving.py:336-352), not yet measured on the card."""
    return 128


def predictor_from_cli_args(parser, args, config) -> "Predictor":
    """Shared flag -> Predictor plumbing for the two serving entry points:
    checkpoint resolution (``--checkpoint`` else ``BEST_MODEL_PATH``),
    ``--buckets`` ('' disables, None keeps the default), ``--device``,
    ``--quant`` and the default batch size. ``--mesh`` is refused with the
    roadmap item that will port it."""
    if args.mesh:
        parser.error("--mesh is not ported to neurovit_tpu_torch yet "
                     "(ROADMAP.md, Queue 1: multi-GPU)")
    ckpt_path = args.checkpoint or os.path.join(
        config.get("GLOBAL_BASE_PATH", "."), config["BEST_MODEL_PATH"])
    buckets = (() if args.buckets == "" else
               None if args.buckets is None else
               tuple(int(b) for b in args.buckets.split(",")))
    batch_size = (args.batch_size if args.batch_size is not None
                  else _default_batch_size())
    return Predictor.from_checkpoint(
        config, ckpt_path, batch_size=batch_size,
        host_transfer_dtype="bf16" if args.host_bf16 else None,
        bucket_sizes=buckets, device=args.device, quant=args.quant)


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
                        help="multi-GPU serving (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch path)")


def main(argv=None) -> None:
    """``python -m neurovit_tpu_torch.serving``: batch inference over NIfTI
    files -- directories, explicit files or a manifest CSV -- one
    prediction row per (file, timepoint) into --output."""
    import argparse
    import csv

    from neurovit_tpu.config import load_config

    parser = argparse.ArgumentParser(
        description="NeuroViT batch prediction (PyTorch / CUDA)")
    parser.add_argument("inputs", nargs="+",
                        help=".nii/.nii.gz files, directories, or a "
                             "manifest CSV (Path_fMRI_brain column)")
    parser.add_argument("--output", default="predictions.csv")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="largest batch (default 128)")
    parser.add_argument("--no-crop", action="store_true",
                        help="skip the ADNI crop [1:, 10:-9, 1:] "
                             "(volumes already at model size)")
    add_serving_args(parser)
    args = parser.parse_args(argv)

    config = load_config(args.config)
    predictor = predictor_from_cli_args(parser, args, config)

    # Stream batch-sized chunks through the predictor: host memory stays
    # bounded at batch_size volumes whatever the manifest's length.
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
        jobs = _collect_volume_jobs(args.inputs, crop=not args.no_crop)
        for path, t, vol in _prefetch_jobs(jobs, depth=predictor.batch_size):
            if chunk_vols and vol.shape != chunk_vols[0].shape:
                flush(f)          # a new spatial shape: its own batch
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
