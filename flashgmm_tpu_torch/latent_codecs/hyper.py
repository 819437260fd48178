"""Hyper (z) branch: h_a -> EntropyBottleneck -> h_s (port of
flashgmm_tpu/latent_codecs/hyper.py). In the reference format's
``compress``/``decompress`` (:46-58) h_a runs as a transform (float32,
canonical strides, pinned library settings) and h_s on the rows chain
(``layers.run_canonical``), since the entropy parameters come from it."""


from flashgmm_tpu_torch.layers import run_canonical, run_transform
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec


@register_module("HyperLatentCodec")
class HyperLatentCodec(LatentCodec):
    """``quantizer`` "ste": h_s reads z rounded around the medians with a
    straight-through gradient (the likelihoods stay those of the
    EntropyBottleneck's own quantization); "noise": h_s reads the
    EntropyBottleneck's output."""

    def __init__(self, entropy_bottleneck, h_a=None, h_s=None,
                 quantizer: str = "noise"):
        super().__init__()
        self.entropy_bottleneck = entropy_bottleneck
        self.h_a = h_a
        self.h_s = h_s
        self.quantizer = quantizer

    def forward(self, y, training: bool = True, generator=None):
        """{"likelihoods": {"z"}, "params": h_s's output}."""
        z = self.h_a(y) if self.h_a is not None else y
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        if self.quantizer == "ste":
            z_medians = self.entropy_bottleneck._get_medians()[:, 0, 0]
            z_hat = quantize_ste(z - z_medians) + z_medians
        params = self.h_s(z_hat) if self.h_s is not None else z_hat
        return {"likelihoods": {"z": z_likelihoods}, "params": params}

    def _h_s_canonical(self, z_hat):
        return run_canonical(self.h_s, z_hat) if self.h_s is not None \
            else z_hat

    def compress(self, y):
        """{"strings": [z strings], "shape": z's (H, W), "params": h_s of
        the decoded z_hat}."""
        z = run_transform(self.h_a, y) if self.h_a is not None else y
        shape = tuple(z.shape[1:3])
        z_strings = self.entropy_bottleneck.compress(z)
        z_hat = self.entropy_bottleneck.decompress(z_strings, shape)
        return {"strings": [z_strings], "shape": shape,
                "params": self._h_s_canonical(z_hat)}

    def decompress(self, strings, shape):
        (z_strings,) = strings
        z_hat = self.entropy_bottleneck.decompress(z_strings, shape)
        return {"params": self._h_s_canonical(z_hat)}
