"""Hyper (z) branch: h_a -> EntropyBottleneck -> h_s (port of
flashgmm_tpu/latent_codecs/hyper.py:15-44)."""

from torch import nn

from flashgmm_tpu_torch.ops import quantize_ste


class HyperLatentCodec(nn.Module):
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
