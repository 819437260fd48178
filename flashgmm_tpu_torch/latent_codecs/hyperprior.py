"""Hyperprior composition: the hyper branch produces the parameters of the
y codec (port of flashgmm_tpu/latent_codecs/hyperprior.py), in the training
forward and in the reference format (:36-52: the y codec's strings, then
the z strings)."""

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

    def compress(self, y):
        hyper_out = self.latent_codec["hyper"].compress(y)
        y_out = self.latent_codec["y"].compress(y, hyper_out["params"])
        [z_strings] = hyper_out["strings"]
        return {"strings": [*y_out["strings"], z_strings],
                "shape": {"y": y_out["shape"], "hyper": hyper_out["shape"]},
                "y_hat": y_out["y_hat"]}

    def decompress(self, strings, shape):
        *y_strings_, z_strings = strings
        hyper_out = self.latent_codec["hyper"].decompress([z_strings],
                                                          shape["hyper"])
        y_out = self.latent_codec["y"].decompress(y_strings_, shape["y"],
                                                  hyper_out["params"])
        return {"y_hat": y_out["y_hat"]}
