"""Host-side batching loader with background prefetch and host sharding.

Replaces torch DataLoader + DistributedSampler
(`train_GF_FSB.py:172-190`): the scan list is sharded by
`jax.process_index()` (per-host input pipelines), shuffled per epoch
with a deterministic seed (the `set_epoch` contract), batched into
dicts of dense numpy arrays, and prefetched on a worker thread so the
next batch is being built while the device is busy.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading

import numpy as np


class DetectionDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            rng.shuffle(order)
        # contiguous per-host shard of the (shuffled) index list
        return order[self.shard_index::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _collate(self, items):
        batch = {}
        for key in items[0]:
            batch[key] = np.stack([it[key] for it in items])
        return batch

    def _produce(self, out_q: queue.Queue, indices):
        try:
            nb = len(self)
            if self.num_workers > 1:
                # per-item fan-out over a thread pool (numpy releases
                # the GIL for the heavy slicing/labeling work)
                with concurrent.futures.ThreadPoolExecutor(
                        self.num_workers) as pool:
                    for b in range(nb):
                        idxs = indices[b * self.batch_size:
                                       (b + 1) * self.batch_size]
                        items = list(pool.map(
                            lambda i: self.dataset.get(
                                int(i), epoch=self.epoch), idxs))
                        out_q.put(self._collate(items))
            else:
                for b in range(nb):
                    idxs = indices[b * self.batch_size:
                                   (b + 1) * self.batch_size]
                    items = [self.dataset.get(int(i), epoch=self.epoch)
                             for i in idxs]
                    out_q.put(self._collate(items))
            out_q.put(None)
        except BaseException as e:  # surface worker errors to consumer
            out_q.put(e)

    def __iter__(self):
        indices = self._indices()
        if self.prefetch <= 0:
            nb = len(self)
            for b in range(nb):
                idxs = indices[b * self.batch_size:(b + 1) * self.batch_size]
                yield self._collate(
                    [self.dataset.get(int(i), epoch=self.epoch)
                     for i in idxs])
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, indices),
                             daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def cycle(loader):
    """Endless iterator with epoch bumping — the BR recipe zips the
    short loader with an `itertools.cycle` of the longer one
    (`train_Votenet_BR.py:267`); this variant reshuffles each pass."""
    epoch = loader.epoch
    while True:
        yield from loader
        epoch += 1
        loader.set_epoch(epoch)
