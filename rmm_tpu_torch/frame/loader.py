"""DataLoader over a host TensorFrame.

Batches keep a fixed ``batch_size`` so every forward sees the same shapes:
the last batch is padded with copies of its last row and carries the count
of real rows (``valid``). Shuffling is seeded.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from .tensor_frame import TensorFrame


class DataLoader:
    def __init__(self, tensor_frame: TensorFrame, batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.tf = tensor_frame
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return -(-self.tf.num_rows // self.batch_size)

    def index_batches(self) -> Iterator[tuple[np.ndarray, int]]:
        """The row ids of each batch (padded) and its real rows, in the
        order ``__iter__`` takes them."""
        n = self.tf.num_rows
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            valid = len(idx)
            if valid < self.batch_size:
                idx = np.concatenate(
                    [idx, np.repeat(idx[-1:], self.batch_size - valid)])
            yield idx, valid

    def __iter__(self) -> Iterator[tuple[TensorFrame, int]]:
        for idx, valid in self.index_batches():
            yield self.tf[idx], valid
