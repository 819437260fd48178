"""Gain-conditioned hyperprior composition (port of
flashgmm_tpu/latent_codecs/gain/hyperprior.py; CompressAI's
latent_codecs/gain/hyperprior.py:46-...): y and z each carry a gain
vector and its inverse, for a continuously variable rate."""

from torch import nn

from flashgmm_tpu_torch.registry import register_module

from ..base import LatentCodec


@register_module("GainHyperpriorLatentCodec")
class GainHyperpriorLatentCodec(LatentCodec):
    def __init__(self, latent_codec=None, **kwargs):
        super().__init__()
        if latent_codec is None or "y" not in latent_codec \
                or "hyper" not in latent_codec:
            raise ValueError("GainHyperpriorLatentCodec needs 'y' and 'hyper'")
        self.latent_codec = nn.ModuleDict(dict(latent_codec))

    def forward(self, y, y_gain, z_gain, y_gain_inv, z_gain_inv,
                training: bool = True, generator=None):
        """{"likelihoods": {"y", "z"}, "y_hat"}: the y codec reads y *
        ``y_gain``, y_hat comes back times ``y_gain_inv``; the hyper branch
        draws its noise from ``generator`` first, then the y codec."""
        hyper_out = self.latent_codec["hyper"](
            y, z_gain, z_gain_inv, training=training, generator=generator)
        y_out = self.latent_codec["y"](y * y_gain, hyper_out["params"],
                                       training=training, generator=generator)
        return {"likelihoods": {"y": y_out["likelihoods"]["y"],
                                "z": hyper_out["likelihoods"]["z"]},
                "y_hat": y_out["y_hat"] * y_gain_inv}

    def compress(self, y, y_gain, z_gain, y_gain_inv, z_gain_inv):
        hyper_out = self.latent_codec["hyper"].compress(y, z_gain, z_gain_inv)
        y_out = self.latent_codec["y"].compress(y * y_gain,
                                                hyper_out["params"])
        [z_strings] = hyper_out["strings"]
        return {"strings": [*y_out["strings"], z_strings],
                "shape": {"y": y_out["shape"], "hyper": hyper_out["shape"]},
                "y_hat": y_out["y_hat"] * y_gain_inv}

    def decompress(self, strings, shape, y_gain_inv, z_gain_inv, **kwargs):
        *y_strings_, z_strings = strings
        hyper_out = self.latent_codec["hyper"].decompress(
            [z_strings], shape["hyper"], z_gain_inv)
        y_out = self.latent_codec["y"].decompress(
            y_strings_, shape["y"], hyper_out["params"])
        return {"y_hat": y_out["y_hat"] * y_gain_inv}
