"""Dataset wrappers (port of flashgmm_tpu/datasets/utils.py; CompressAI's
compressai/datasets/utils.py): ``NdArrayDataset``. The JAX package's
CacheDataset, StackDataset and PreGeneratedMemmapDataset wait for ROADMAP
item 15."""


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
