"""Hyper (z) branch container: h_a -> EntropyBottleneck -> h_s (port of
flashgmm_tpu/latent_codecs/hyper.py; the module tree only)."""

from torch import nn


class HyperLatentCodec(nn.Module):
    def __init__(self, entropy_bottleneck, h_a=None, h_s=None):
        super().__init__()
        self.entropy_bottleneck = entropy_bottleneck
        self.h_a = h_a
        self.h_s = h_s
