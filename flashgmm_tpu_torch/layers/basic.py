"""Basic structural layers on NHWC tensors (port of
flashgmm_tpu/layers/basic.py; compressai/layers/basic.py:47-112)."""

from typing import Callable, Sequence

from torch import nn


class Lambda(nn.Module):
    """A function as a layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class NamedLayer(nn.Module):
    """No-op layer carrying a name (useful for checkpoint key mapping)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, x):
        return x


class Reshape(nn.Module):
    """x -> [batch, *shape]."""

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape(x.shape[0], *self.shape)


class Transpose(nn.Module):
    """x permuted by ``axes`` (``jnp.transpose``'s)."""

    def __init__(self, axes: Sequence[int]):
        super().__init__()
        self.axes = tuple(axes)

    def forward(self, x):
        return x.permute(*self.axes)


class Interleave(nn.Module):
    """Interleave channel groups: [g0c0, g1c0, g0c1, ...]."""

    def __init__(self, groups: int):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        g = self.groups
        n, h, w, c = x.shape
        return (x.reshape(n, h, w, g, c // g).transpose(3, 4)
                .reshape(n, h, w, c))
