"""The latent codec protocol (port of flashgmm_tpu/latent_codecs/base.py;
CompressAI's latent_codecs/base.py:41-89).

A latent codec bundles a probability model with the networks around it:

- ``forward(y, ...) -> {"likelihoods": {...}, "y_hat": ...}`` (training)
- ``compress(y, ...) -> {"strings": [...], "shape": ..., "y_hat": ...}``
- ``decompress(strings, shape, ...) -> {"y_hat": ...}``

Tensors are NHWC; sub-codecs live in an ``nn.ModuleDict`` named
``latent_codec``, as the JAX package's parameter paths name them.
"""

from torch import nn


class LatentCodec(nn.Module):
    def forward(self, y, *args, **kwargs):
        raise NotImplementedError

    def compress(self, y, *args, **kwargs):
        raise NotImplementedError

    def decompress(self, strings, shape, *args, **kwargs):
        raise NotImplementedError

    def __getitem__(self, key: str) -> "LatentCodec":
        return self.latent_codec[key]
