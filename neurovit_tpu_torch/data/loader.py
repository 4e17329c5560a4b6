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
                 shard: "tuple[int, int] | None" = None):
        """``shard=(rank, world)`` gives this loader a disjoint 1/world slice
        of the (per-epoch shuffled) index space — the multi-HOST data
        parallelism contract: each process feeds its OWN rows and
        ``parallel.shard_batch`` assembles the global batch from them. All
        ranks see the same shuffle (same seed+epoch) and the same number of
        batches (short shards wrap), so SPMD processes stay in lockstep."""
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
        self.shard = shard
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

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.shard is None:
            return n
        return -(-n // self.shard[1])         # ceil: every rank equal-length

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self.epoch = epoch

    def _index_order(self):
        """(indices, wrap_mask): wrap rows are the duplicates appended so
        every rank yields the same number of batches in lockstep; they are
        marked valid=False downstream so multi-host metrics don't
        double-count up to world-1 samples per epoch (the same masking
        mechanism _collate uses for padding)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.shard is not None:
            rank, world = self.shard
            mine = order[rank::world]
            target = self._shard_len()
            wrap = np.zeros(target, np.bool_)
            if len(mine) < target:            # wrap so all ranks yield the
                wrap[len(mine):] = True       # same number of batches
                mine = np.concatenate([mine, mine[: target - len(mine)]])
            return mine, wrap
        return order, np.zeros(n, np.bool_)

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
        order, wrap = self._index_order()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        sl = slice(b * self.batch_size,
                                   (b + 1) * self.batch_size)
                        idxs, wraps = order[sl], wrap[sl]
                        pairs = [(s, w) for s, w in
                                 zip(pool.map(self._fetch, idxs), wraps)
                                 if s is not None]
                        if not pairs:
                            continue
                        batch = self._collate([s for s, _ in pairs])
                        wraps = np.array([w for _, w in pairs])
                        batch["valid"][:len(wraps)] &= ~wraps
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

