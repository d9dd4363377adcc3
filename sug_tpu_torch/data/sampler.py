"""Batch iteration: counterpart of ``sug_tpu/data/sampler.py`` for one
process. The shuffles are drawn with numpy exactly as the JAX package draws
them, so the same seed and epoch give the same batches."""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from sug_tpu_torch.data.datasets import PointCloudDataset


class BatchIterator:
    """Batches of a dataset: shuffled by ``default_rng(seed + epoch)`` and
    drop-last by default; ``shuffle=False, drop_last=False`` gives dataset
    order with a short last batch (evaluation). Call ``set_epoch`` each
    epoch, or every epoch reuses epoch 0's shuffle."""

    def __init__(self, dataset: PointCloudDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 666):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.dataset.pts[idx], self.dataset.labels[idx]


class ClassBalancedBatchIterator:
    """Class-balanced batches: each epoch draws ``class_per_batch`` classes,
    then every batch element from a random chosen class and a random cloud
    of it; ``len(dataset) // batch_size`` batches per epoch."""

    def __init__(self, dataset: PointCloudDataset, batch_size: int, class_per_batch: int = 10,
                 seed: int = 666):
        self.dataset = dataset
        self.classes: List[List[int]] = dataset.indices
        self.batch_size = batch_size
        self.class_per_batch = class_per_batch
        self.n_batches = sum(len(x) for x in self.classes) // batch_size
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.n_batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        nonempty = [i for i, x in enumerate(self.classes) if len(x) > 0]
        k = min(self.class_per_batch, len(nonempty))
        chosen = np.random.default_rng((self.seed, self.epoch)).choice(nonempty, size=k, replace=False)
        # the JAX package's per-sample stream of process 0
        rng = np.random.default_rng((self.seed, self.epoch, 0))
        for _ in range(self.n_batches):
            klass = rng.choice(chosen, size=self.batch_size)
            idx = np.array([self.classes[c][rng.integers(len(self.classes[c]))] for c in klass])
            yield self.dataset.pts[idx], self.dataset.labels[idx]
