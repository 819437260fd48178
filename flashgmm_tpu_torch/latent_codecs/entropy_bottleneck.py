"""The EntropyBottleneck as a latent codec (port of
flashgmm_tpu/latent_codecs/entropy_bottleneck.py; CompressAI's
latent_codecs/entropy_bottleneck.py:44-88)."""

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec


@register_module("EntropyBottleneckLatentCodec")
class EntropyBottleneckLatentCodec(LatentCodec):
    """``entropy_bottleneck`` or a new one over ``channels`` (keyword
    arguments go to ``EntropyBottleneck``)."""

    def __init__(self, entropy_bottleneck=None, channels: int = None,
                 **kwargs):
        super().__init__()
        if entropy_bottleneck is None:
            entropy_bottleneck = EntropyBottleneck(channels, **kwargs)
        self.entropy_bottleneck = entropy_bottleneck

    def forward(self, y, training: bool = True, generator=None):
        y_hat, y_likelihoods = self.entropy_bottleneck(
            y, training=training, generator=generator)
        return {"likelihoods": {"y": y_likelihoods}, "y_hat": y_hat}

    def compress(self, y):
        """{"strings": [one string an image], "shape": (H, W), "y_hat":
        decoded from the strings}."""
        shape = tuple(y.shape[1:3])
        y_strings = self.entropy_bottleneck.compress(y)
        y_hat = self.entropy_bottleneck.decompress(y_strings, shape)
        return {"strings": [y_strings], "shape": shape, "y_hat": y_hat}

    def decompress(self, strings, shape, **kwargs):
        (y_strings,) = strings
        return {"y_hat": self.entropy_bottleneck.decompress(y_strings,
                                                            tuple(shape))}
