"""Hyperprior composition container: the hyper branch produces the
parameters of the y codec (port of flashgmm_tpu/latent_codecs/hyperprior.py;
the module tree only)."""

from torch import nn


class HyperpriorLatentCodec(nn.Module):
    def __init__(self, latent_codec):
        super().__init__()
        if "y" not in latent_codec or "hyper" not in latent_codec:
            raise ValueError("HyperpriorLatentCodec needs 'y' and 'hyper'")
        self.latent_codec = nn.ModuleDict(dict(latent_codec))
