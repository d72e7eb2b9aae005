"""Host input pipeline: dataset → fixed-shape numpy batches with background
prefetch.

Replaces the reference's torch DataLoader + DistributedSampler stack
(``tools/builder.py:14-31``). Each process iterates its own shard of the
(epoch-shuffled) index list. The heavy per-batch work (crop/noise) is NOT
here; it runs on the device, so this loader only reads, stacks and
prefetches raw clouds.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def shard_indices(idx: np.ndarray, num_shards: int, shard_index: int) -> np.ndarray:
    """Shard ``shard_index``'s share of ``idx``: every ``num_shards``-th
    entry, after padding ``idx`` with its first entries to a multiple of
    ``num_shards`` so every host sees equal batches (the padding repeats
    samples: evaluation drops them by index)."""
    if num_shards == 1:
        return idx
    n = len(idx)
    per = -(-n // num_shards)
    padded = np.concatenate([idx, idx[: per * num_shards - n]])
    return padded[shard_index::num_shards]


class BatchLoader:
    """Minimal epoch-based batch iterator.

    Args:
      dataset: indexable returning (taxonomy, model_id, (points, label)) or
        (points, cls, seg) tuples (the two reference item shapes).
      batch_size: per-host batch size.
      shuffle: reshuffle indices each epoch (train).
      drop_last: drop the trailing partial batch (train).
      seed: base shuffle seed; epoch is mixed in (DistributedSampler.set_epoch
        analogue, ``tools/runner_module.py:89-90``).
      num_shards / shard_index: per-host sharding (process_count/index).
      prefetch: number of batches to stage from a background thread.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
            rng.shuffle(idx)
        return shard_indices(idx, self.num_shards, self.shard_index)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _collate(items) -> Tuple[np.ndarray, ...]:
        first = items[0]
        if len(first) == 3 and isinstance(first[2], tuple):
            pts = np.stack([it[2][0] for it in items]).astype(np.float32)
            labels = np.asarray([it[2][1] for it in items], np.int32)
            return pts, labels
        # segmentation tuple (point_set, cls, seg)
        pts = np.stack([it[0] for it in items]).astype(np.float32)
        cls = np.asarray([int(np.asarray(it[1]).reshape(-1)[0]) for it in items],
                         np.int32)
        seg = np.stack([it[2] for it in items]).astype(np.int32)
        return pts, cls, seg

    def _batches(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for _, batch in self._indexed_batches():
            yield batch

    def _assemble(self, chunk):
        """One collated batch; datasets exposing ``get_batch`` (e.g.
        ShapeNet55's native parallel .npy reader) build it in one call,
        otherwise per-item ``__getitem__`` + collate."""
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is not None:
            batch = get_batch(chunk)
            if batch is not None:
                return batch
        return self._collate([self.dataset[i] for i in chunk])

    def _indexed_batches(self):
        idx = self._indices()
        n_full = len(idx) // self.batch_size
        ends = n_full * self.batch_size
        for s in range(0, ends, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            yield chunk, self._assemble(chunk)
        if not self.drop_last and ends < len(idx):
            chunk = idx[ends:]
            yield chunk, self._assemble(chunk)

    def iter_indexed(self):
        """Yield (global dataset indices [b], batch tuple). Shard padding
        duplicates indices (``_indices``); eval code dedupes on them so
        multi-host metrics aren't biased by repeated samples. Uses the same
        background prefetch thread as ``__iter__``."""
        yield from self._prefetched(self._indexed_batches())

    def __iter__(self):
        yield from self._prefetched(self._batches())

    def _prefetched(self, gen):
        """Run ``gen`` on a background thread with a bounded queue so host
        dataset reads overlap device dispatch; exceptions re-raise on the
        consumer thread."""
        if self.prefetch <= 0:
            yield from gen
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            try:
                for b in gen:
                    q.put(b)
                q.put(_END)
            except BaseException as e:  # re-raised on the consumer thread
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is _END:
                break
            if isinstance(b, BaseException):
                raise b
            yield b
