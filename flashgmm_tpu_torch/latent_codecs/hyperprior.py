"""Hyperprior composition: the hyper branch produces the parameters of the
y codec (port of flashgmm_tpu/latent_codecs/hyperprior.py:14-34)."""

from torch import nn


class HyperpriorLatentCodec(nn.Module):
    def __init__(self, latent_codec):
        super().__init__()
        if "y" not in latent_codec or "hyper" not in latent_codec:
            raise ValueError("HyperpriorLatentCodec needs 'y' and 'hyper'")
        self.latent_codec = nn.ModuleDict(dict(latent_codec))

    def forward(self, y, training: bool = True, generator=None):
        """{"likelihoods": {"y", "z"}, "y_hat"}; the hyper branch draws its
        noise from ``generator`` first, then the y codec."""
        hyper_out = self.latent_codec["hyper"](y, training=training,
                                               generator=generator)
        y_out = self.latent_codec["y"](y, hyper_out["params"],
                                       training=training, generator=generator)
        return {"likelihoods": {"y": y_out["likelihoods"]["y"],
                                "z": hyper_out["likelihoods"]["z"]},
                "y_hat": y_out["y_hat"]}
