"""Dataset wrappers (port of flashgmm_tpu/datasets/utils.py; CompressAI's
compressai/datasets/utils.py): ``NdArrayDataset`` (an in-memory array),
``CacheDataset`` (another dataset's items memoized), ``StackDataset`` (item
i of several datasets as one tuple) and ``PreGeneratedMemmapDataset``
(fixed-shape samples in one memory-mapped file). numpy in, numpy out."""

import numpy as np


class NdArrayDataset:
    """An in-memory array (or tuple of arrays) as a dataset."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        if isinstance(self.arrays, (tuple, list)):
            return len(self.arrays[0])
        return len(self.arrays)

    def __getitem__(self, idx):
        if isinstance(self.arrays, (tuple, list)):
            return tuple(a[idx] for a in self.arrays)
        return self.arrays[idx]


class CacheDataset:
    """Memoize another dataset's items in RAM."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._cache = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        if idx not in self._cache:
            self._cache[idx] = self.dataset[idx]
        return self._cache[idx]


class StackDataset:
    """Zip multiple datasets: item i -> tuple of each dataset's item i."""

    def __init__(self, *datasets):
        if any(len(d) != len(datasets[0]) for d in datasets):
            raise ValueError("StackDataset: datasets of different lengths")
        self.datasets = datasets

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        return tuple(d[idx] for d in self.datasets)


class PreGeneratedMemmapDataset:
    """Fixed-shape samples stored in a single memmapped file."""

    def __init__(self, path, shape, dtype=np.float32):
        self.item_shape = tuple(shape)
        self.data = np.memmap(path, dtype=dtype, mode="r")
        item_size = int(np.prod(self.item_shape))
        self.length = self.data.size // item_size
        self.data = self.data[: self.length * item_size].reshape(
            (self.length,) + self.item_shape)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return np.asarray(self.data[idx])
