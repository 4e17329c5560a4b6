"""Host-side batch loader: threaded sample fetch + background prefetch.

The port's copy of ``neurovit_tpu/data/loader.py``, the replacement for the
reference's
``torch.utils.data.DataLoader(num_workers=16, pin_memory=True,
prefetch_factor=2)`` (``src/Trainer.py:26-27``): a thread pool fetches samples
(NIfTI reads release the GIL in numpy/memmap), a producer thread assembles
fixed-shape numpy batches and keeps a bounded prefetch queue ahead of the
training loop, and the trainer overlaps host->HBM transfer with device
compute (JAX dispatch is async).

Fixed shapes for jit: the trailing partial batch is padded to ``batch_size``
and carries a ``valid`` mask so metrics/losses count exactly the real samples
(the reference sees a smaller final batch instead; same sample semantics, one
compiled shape).

The JAX package's whole-batch fast path for datasets that read through its
native C++ reader (``_batched_read``, loader.py:162-206) is left out with
that reader: every batch here is assembled from per-sample reads.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Sequence

import numpy as np

# Fields stacked into numpy arrays; everything else is passed through as a
# python list (subjects are strings, reference Trainer.py:65).
ARRAY_FIELDS = ("volume", "label", "timepoint", "group", "gender", "age",
                "age_group", "coordinates", "pain_group")


def zyx_base(v) -> Any:
    """The raw C-contiguous [Z, Y, X] buffer behind a z-major volume view.

    Datasets return volumes whose memory is z-major, exposed as [X, Y, Z]
    transpose views (adni.py _read_volume). Stacking the raw buffers is pure
    memcpy; stacking the views would re-transpose every sample on the host
    (~1.5 ms/volume, the full win of the z-major read). Returns None when
    ``v`` is not such a view (e.g. synthetic datasets, transformed crops).
    """
    if getattr(v, "ndim", 0) == 3 and v.base is not None:
        t = v.transpose(2, 1, 0)
        if t.flags.c_contiguous:
            return t
    return None


def stack_volumes(vals):
    """np.stack for volumes that keeps z-major batches zero-transpose.

    Returns ``(batch, zyx)``. The batch always indexes as [B, X, Y, Z]; when
    every input is a z-major view (zyx=True) the returned array is itself a
    transpose view of a C-contiguous [B, Z, Y, X] buffer, which the trainer
    ships to the device raw (the layout transpose happens device-side, fused
    into the input cast). The bool is the loader's explicit layout statement
    — consumers must trust it rather than re-sniffing array flags.
    """
    bases = [zyx_base(np.asarray(v)) for v in vals]
    if all(b is not None for b in bases):
        return np.stack(bases).transpose(0, 3, 2, 1), True
    return np.stack([np.asarray(v) for v in vals]), False


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2, retries: int = 1,
                 shard: "tuple[int, int] | None" = None,
                 global_batch: "int | None" = None):
        """``shard=(rank, world)`` gives this loader its rows of every
        global batch of ``global_batch`` samples (default ``batch_size *
        world``) — the multi-process data parallelism contract: each
        process feeds its OWN rows. Global batch k is the unsharded
        loader's batch k padded to a multiple of ``world`` as the JAX
        trainer pads (trainer.py:711-721): its short tail repeats its last
        sample with ``valid`` False, and the rows past ``global_batch``
        repeat it too with label 0. Rank r takes rows r, r + world, ... of
        it (``parallel.sharding.local_rows``'s layout), ``batch_size`` =
        ceil(global_batch / world) rows. All ranks see the same shuffle
        (same seed+epoch) and the same number of batches, so SPMD processes
        stay in lockstep."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        if shard is not None:
            rank, world = shard
            assert 0 <= rank < world, shard
            assert len(dataset) >= world, (
                f"dataset of {len(dataset)} samples cannot feed {world} "
                f"processes")
            global_batch = global_batch or batch_size * world
            assert batch_size == -(-global_batch // world), (
                batch_size, global_batch, world)
        self.shard = shard
        self.global_batch = global_batch
        # Transient-I/O resilience (the reference has none, SURVEY §5.3):
        # a failed/None sample read is retried before being skipped+masked.
        self.retries = retries
        self.epoch = 0

    def _fetch(self, idx):
        for attempt in range(self.retries + 1):
            try:
                sample = self.dataset.sample(idx)
            except Exception as e:
                if attempt == self.retries:
                    raise
                print(f"Retrying sample {idx} after error: {e}")
                continue
            if sample is not None:
                return sample
        return None

    def __len__(self) -> int:
        n = len(self.dataset)
        per = self.batch_size if self.shard is None else self.global_batch
        if self.drop_last:
            return n // per
        return (n + per - 1) // per

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self.epoch = epoch

    def _index_order(self):
        """The (per-epoch shuffled) order of the dataset's indices."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _batch_rows(self, order, b: int):
        """Batch b's rows: (indices, valid, label zeroed). Unsharded, the
        batch's real samples (_collate pads it). Sharded, this rank's rows
        of global batch b padded to a multiple of the world: a row past
        the batch's real samples repeats its last one, invalid, its label
        zeroed past ``global_batch`` (the JAX trainer's pad rows)."""
        if self.shard is None:
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            return idxs, np.ones(len(idxs), np.bool_), None
        rank, world = self.shard
        g = self.global_batch
        start = b * g
        real = min(g, len(order) - start)
        rows = np.arange(rank, self.batch_size * world, world)
        idxs = order[start + np.minimum(rows, real - 1)]
        return idxs, rows < real, rows >= g

    def _collate(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        n_real = len(samples)
        pad = self.batch_size - n_real
        if pad:
            samples = list(samples) + [samples[-1]] * pad
        batch: Dict[str, Any] = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if key == "volume":
                batch[key], batch["zyx"] = stack_volumes(vals)
            elif key in ARRAY_FIELDS:
                batch[key] = np.stack([np.asarray(v) for v in vals])
            else:
                batch[key] = vals
        batch["valid"] = np.arange(self.batch_size) < n_real
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._index_order()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        idxs, valid, zero = self._batch_rows(order, b)
                        pairs = [(s, v) for s, v in
                                 zip(pool.map(self._fetch, idxs), valid)
                                 if s is not None]
                        if not pairs:
                            continue
                        batch = self._collate([s for s, _ in pairs])
                        valid = np.array([v for _, v in pairs])
                        batch["valid"][:len(valid)] &= valid
                        if (zero is not None and "label" in batch
                                and len(pairs) == len(zero)):
                            batch["label"] = np.where(zero, 0,
                                                      batch["label"])
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit if we stopped early.
            while producer.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break

