"""Gain-conditioned hyper (z) branch (port of
flashgmm_tpu/latent_codecs/gain/hyper.py; CompressAI's
latent_codecs/gain/hyper.py:47-...).

As ``HyperLatentCodec``, but z is multiplied by a gain vector before the
EntropyBottleneck and z_hat by its inverse after it (Cui et al.,
"Asymmetric Gained Deep Image Compression"). In the reference format h_a
runs as a transform and h_s on the rows chain (``layers.run_canonical``),
as in ``HyperLatentCodec``.
"""

from flashgmm_tpu_torch.layers import run_canonical, run_transform
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_module

from ..base import LatentCodec


@register_module("GainHyperLatentCodec")
class GainHyperLatentCodec(LatentCodec):
    """``gain`` and ``gain_inv``: channel vectors of z."""

    def __init__(self, entropy_bottleneck=None, h_a=None, h_s=None,
                 **kwargs):
        super().__init__()
        if entropy_bottleneck is None:
            raise ValueError("GainHyperLatentCodec needs an entropy_bottleneck")
        self.entropy_bottleneck = entropy_bottleneck
        self.h_a = h_a
        self.h_s = h_s

    def forward(self, y, gain, gain_inv, training: bool = True,
                generator=None):
        """{"likelihoods": {"z"}, "params"}: h_s reads z rounded around the
        medians with a straight-through gradient, times ``gain_inv``."""
        z = self.h_a(y) if self.h_a is not None else y
        z = z * gain
        _, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        z_medians = self.entropy_bottleneck._get_medians()[:, 0, 0]
        z_hat = (quantize_ste(z - z_medians) + z_medians) * gain_inv
        params = self.h_s(z_hat) if self.h_s is not None else z_hat
        return {"likelihoods": {"z": z_likelihoods}, "params": params}

    def _h_s_canonical(self, z_hat):
        return run_canonical(self.h_s, z_hat) if self.h_s is not None \
            else z_hat

    def compress(self, y, gain, gain_inv):
        """{"strings": [z strings], "shape": z's (H, W), "params": h_s of
        the decoded z_hat times ``gain_inv``}."""
        z = run_transform(self.h_a, y) if self.h_a is not None else y
        z = z * gain
        shape = tuple(z.shape[1:3])
        z_strings = self.entropy_bottleneck.compress(z)
        z_hat = self.entropy_bottleneck.decompress(z_strings, shape) * gain_inv
        return {"strings": [z_strings], "shape": shape,
                "params": self._h_s_canonical(z_hat)}

    def decompress(self, strings, shape, gain_inv, **kwargs):
        (z_strings,) = strings
        z_hat = self.entropy_bottleneck.decompress(z_strings, tuple(shape)) \
            * gain_inv
        return {"params": self._h_s_canonical(z_hat)}
