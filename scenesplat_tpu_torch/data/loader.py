"""Host-side loaders of fixed-shape padded batches (the port's copy of
``scenesplat_tpu/data/loader.py``: ``Loader``, ``MultiDatasetLoader``).

A thread pool prepares samples two batches ahead; each sample's transforms
draw from a generator seeded by (seed, epoch, sample index), and collate's
Mix3D and downsampling draws by (seed, epoch, batch index), so batches do
not depend on the number of workers or on thread scheduling. A
``collate_fn`` takes collate's place (the SSL trainer's ``collate_ssl``).

``batch_size`` is the global batch. Under data parallel every process
computes the same shuffled order and loads only its contiguous block of
each batch's samples, in rank order; collate's draws stay keyed by the
batch index, on each process's own samples, as in the JAX package, so a
batch of two processes is not one process's batch cut in two.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from scenesplat_tpu_torch.parallel.dist import rank, world

from .collate import collate_padded
from .transforms import seed_transforms


class Loader:
    """Epoch-based shuffling loader over one dataset."""

    def __init__(self, dataset, batch_size: int, num_points: int, mix_prob: float = 0.0,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 drop_last: bool = True, collate_fn=None,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_points = num_points
        self.mix_prob = mix_prob
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.epoch = 0
        # this process's rows: the process group's unless given (tests)
        self.process_index = rank() if process_index is None else process_index
        self.process_count = world() if process_count is None else process_count
        # Mix3D consumes two source samples per batch slot (see collate)
        self.samples_per_batch = batch_size * (2 if mix_prob > 0 else 1)
        if self.process_count > 1:
            if self.samples_per_batch % self.process_count:
                raise ValueError(f"a global batch of {self.samples_per_batch} samples does "
                                 f"not split over {self.process_count} processes")
            if not drop_last:
                raise ValueError("data parallel loading needs drop_last (a short last "
                                 "batch does not split evenly over the processes)")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n, spb = len(self.dataset), self.samples_per_batch
        return n // spb if self.drop_last else -(-n // spb)

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _fetch(self, i: int):
        seed_transforms((self.seed, self.epoch, i, 0))
        return self.dataset[i]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        nb, spb = len(self), self.samples_per_batch
        local = spb // self.process_count
        first = self.process_index * local
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = queue.Queue()

            def submit(bi):
                batch_idx = order[bi * spb:(bi + 1) * spb][first:first + local]
                pending.put([pool.submit(self._fetch, int(i)) for i in batch_idx])

            ahead = min(2, nb)
            for bi in range(ahead):
                submit(bi)
            for bi in range(nb):
                futures = pending.get()
                if bi + ahead < nb:
                    submit(bi + ahead)
                samples = [f.result() for f in futures]
                seed_transforms((self.seed, self.epoch, bi, 1))  # collate's draws
                if self.collate_fn is not None:
                    yield self.collate_fn(samples)
                else:
                    yield collate_padded(samples, self.num_points, mix_prob=self.mix_prob)


class MultiDatasetLoader:
    """Interleaves batches of a ConcatDataset's children by their ``loop``
    ratio; every batch comes from one child."""

    def __init__(self, concat_dataset, batch_size: int, num_points: int,
                 mix_prob: float = 0.0, seed: int = 0, num_workers: int = 4,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.children = concat_dataset.datasets
        self.loaders = [
            Loader(ds, batch_size=batch_size, num_points=num_points, mix_prob=mix_prob,
                   shuffle=True, seed=seed + 31 * i, num_workers=num_workers,
                   process_index=process_index, process_count=process_count)
            for i, ds in enumerate(self.children)
        ]
        self.ratios = [max(1, int(getattr(ds, "loop", 1))) for ds in self.children]
        # the ConcatDataset's own loop is the per-epoch data-pass multiplier
        self.loop = max(1, int(getattr(concat_dataset, "loop", 1)))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.loop * sum(len(ld) for ld in self.loaders)

    def __iter__(self):
        for rep in range(self.loop):
            for loader in self.loaders:
                loader.set_epoch(self.epoch * self.loop + rep)
            iters = [iter(ld) for ld in self.loaders]
            remaining = [len(ld) for ld in self.loaders]
            while any(r > 0 for r in remaining):
                for i, ratio in enumerate(self.ratios):
                    for _ in range(ratio):
                        if remaining[i] <= 0:
                            break
                        yield next(iters[i])
                        remaining[i] -= 1
