"""Host input pipeline: threaded batch assembly and a device feed one step ahead.

Port of `panopticdiffusionmodels_tpu/data/loader.py`:

  * `Loader` shuffles with the same `random.Random(seed)`, drops the last
    partial batch the same way and fast-forwards index-only (`skip`), so it
    yields exactly the JAX loader's batches; a thread pool assembles them.
    Over several processes `batch_size` stays the GLOBAL batch: every
    process draws the same shuffle from the same seed and loads only its
    rows of each global batch, the contiguous `batch_size / process_count`
    slice of process `process_index` by default, or `local_rows`;
  * `prefetch_to_device` converts each numpy batch to tensors on a
    background thread (optional casts, pinned host memory for a card) and
    starts its host-to-device copy (`non_blocking`, on the current stream)
    one step before the batch is consumed.
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np
import torch


def _collate(samples):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class Loader:
    """Infinite shuffled batch iterator over a map-style dataset; each epoch
    drops its last partial batch.  Yields this process's rows of each global
    batch of `batch_size`."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 local_rows: Optional[slice] = None):
        if len(dataset) < batch_size:
            raise ValueError(f"dataset of {len(dataset)} samples is smaller than one batch "
                             f"({batch_size})")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {process_count} "
                             "processes")
        if local_rows is None:
            per = batch_size // process_count
            local_rows = slice(process_index * per, (process_index + 1) * per)
        self.local_rows = local_rows
        self.dataset = dataset
        self.batch_size = batch_size
        self.pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
        self.seed = seed
        self.rng = random.Random(seed)
        self._epochs = 0  # epochs whose order has been drawn
        self._pending: tuple = ()  # (epoch indices, start batch) set by skip()

    def _epoch_indices(self):
        """The next epoch's order; a dataset with `set_epoch` (per-epoch
        random draws, e.g. `CFGLabelDataset`) is told its epoch and seed."""
        idx = list(range(len(self.dataset)))
        self.rng.shuffle(idx)
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self._epochs, self.seed)
        self._epochs += 1
        return idx

    def _n_batches(self, idx) -> int:
        return len(idx) // self.batch_size

    def skip(self, n_batches: int):
        """Fast-forward by `n_batches` without loading a sample: afterwards the
        stream yields what a fresh loader yields from batch `n_batches` on."""
        assert not self._pending, "skip() must precede iteration"
        while n_batches > 0:
            idx = self._epoch_indices()
            nb = self._n_batches(idx)
            if n_batches >= nb:
                n_batches -= nb
            else:
                self._pending = (idx, n_batches)
                return

    def epoch(self) -> Iterator[Any]:
        if self._pending:
            (idx, start), self._pending = self._pending, ()
        else:
            idx, start = self._epoch_indices(), 0
        for b in range(start, self._n_batches(idx)):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size][self.local_rows]
            if self.pool is not None:
                samples = list(self.pool.map(self.dataset.__getitem__, batch_idx))
            else:
                samples = [self.dataset[i] for i in batch_idx]
            yield _collate(samples)

    def __iter__(self) -> Iterator[Any]:
        while True:
            yield from self.epoch()


def _to_host_tensor(x, cast_f32: Optional[torch.dtype], cast_int, pin: bool) -> torch.Tensor:
    x = np.asarray(x)
    if cast_int is not None and x.dtype in (np.dtype(np.int32), np.dtype(np.int64)):
        info = np.iinfo(cast_int)
        lo, hi = int(x.min()), int(x.max())
        if lo < info.min or hi > info.max:
            raise ValueError(f"cast_int={np.dtype(cast_int).name}: batch int field range "
                             f"[{lo}, {hi}] exceeds [{info.min}, {info.max}]")
        x = x.astype(cast_int)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if cast_f32 is not None and t.dtype == torch.float32:
        t = t.to(cast_f32)
    return t.pin_memory() if pin else t


def prefetch_to_device(iterator, device, cast_f32: Optional[torch.dtype] = None,
                       cast_int=None) -> Iterator[Any]:
    """Yield each batch of `iterator` as tensors on `device`.

    `cast_f32`: a torch dtype (bfloat16) that float32 fields are cast to on
    the host before the copy, halving its bytes.  `cast_int`: a narrow numpy
    integer type (np.uint8) for int32/int64 fields, lossless by contract (the
    8-bit analog-bit codec needs ids < 256); a batch out of its range raises
    instead of wrapping.  Host conversion runs on a background thread up to two
    batches ahead; the copy of batch k+1 is started before batch k is
    yielded.  Errors of the data pipeline are raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def host(batch):
        if isinstance(batch, tuple):
            return tuple(_to_host_tensor(x, cast_f32, cast_int, pin) for x in batch)
        return _to_host_tensor(batch, cast_f32, cast_int, pin)

    def worker():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                q.put(host(batch))
            q.put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            q.put(e)

    def fetch():
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        if item is None:
            return None
        if isinstance(item, tuple):
            return tuple(t.to(device, non_blocking=True) for t in item)
        return item.to(device, non_blocking=True)

    threading.Thread(target=worker, daemon=True).start()
    try:
        nxt = fetch()
        while nxt is not None:
            cur, nxt = nxt, fetch()
            yield cur
    finally:
        stop.set()
