"""Batch iteration for evaluation: counterpart of ``BatchIterator(shuffle=
False, drop_last=False)`` in ``sug_tpu/data/sampler.py``. The shuffled,
class-balanced and multi-process iterators come with the training slice."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from sug_tpu_torch.data.datasets import PointCloudDataset


class BatchIterator:
    """Sequential batches in dataset order; the last one may be short."""

    def __init__(self, dataset: PointCloudDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for start in range(0, len(self.dataset), self.batch_size):
            stop = start + self.batch_size
            yield self.dataset.pts[start:stop], self.dataset.labels[start:stop]
