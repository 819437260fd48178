"""The Ballé/Minnen model line (port of flashgmm_tpu/models/google.py;
CompressAI's models/google.py:66-736): the factorized prior (with GDN or
ReLU), the scale hyperprior, the mean-scale hyperprior (table or
search coding) and the joint autoregressive hierarchical prior.

Built on the CPU from a ``torch.Generator`` (``generator``, else one seeded
with ``seed``), then moved to ``device`` (the card unless the caller asks
otherwise). Module paths equal the JAX package's parameter paths
(``zoo.load_npz``); a CompressAI state dict loads through
``zoo.torch_convert``. Images are NHWC [B, H, W, 3].

Reference-format coding (run ``update()`` first): g_a and h_a run as
transforms (``layers.run_transform``: float32, canonical strides, pinned
library settings) and h_s on the rows chain (``layers.run_canonical``) in
both directions, since the y coder's table indexes, or its Gaussian rows,
come from h_s: the card's strings decode on the CPU and the other way
round. g_s runs as a transform and is clamped to [0, 1]. ``compress``
returns ``y_hat`` beside the reference's keys (the value the decoder
reconstructs) and ``decompress_y`` gives the decoder's y_hat alone.
"""

import torch

from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               GaussianConditional)
from flashgmm_tpu_torch.layers import (GDN, Conv2d, LeakyReLU, MaskedConv2d,
                                       ReLU, Sequential, conv, deconv,
                                       run_canonical, run_transform)
from flashgmm_tpu_torch.registry import register_model
from flashgmm_tpu_torch.runtime import rasterscan

from .base import CompressionModel


def _generator(seed, generator):
    return generator if generator is not None \
        else torch.Generator().manual_seed(int(seed))


def _gdn_g_a(N, M, g):
    return Sequential(
        conv(3, N, generator=g), GDN(N),
        conv(N, N, generator=g), GDN(N),
        conv(N, N, generator=g), GDN(N),
        conv(N, M, generator=g),
    )


def _igdn_g_s(N, M, g):
    return Sequential(
        deconv(M, N, generator=g), GDN(N, inverse=True),
        deconv(N, N, generator=g), GDN(N, inverse=True),
        deconv(N, N, generator=g), GDN(N, inverse=True),
        deconv(N, 3, generator=g),
    )


def _decoded(g_s, y_hat):
    return {"x_hat": torch.clamp(run_transform(g_s, y_hat), 0.0, 1.0)}


@register_model("bmshj2018-factorized")
class FactorizedPrior(CompressionModel):
    """Factorized-prior VAE (google.py:66-167): 4 strided convs with GDN each
    way, an EntropyBottleneck over the latent."""

    def __init__(self, N, M, *, seed: int = 0, device="cuda", generator=None,
                 **kwargs):
        super().__init__()
        g = _generator(seed, generator)
        self.entropy_bottleneck = EntropyBottleneck(M, generator=g)
        self.g_a = _gdn_g_a(N, M, g)
        self.g_s = _igdn_g_s(N, M, g)
        self.N, self.M = int(N), int(M)
        self.to(device)

    @property
    def downsampling_factor(self) -> int:
        return 2 ** 4

    def forward(self, x, training: bool = True, generator=None):
        y = self.g_a(x)
        y_hat, y_likelihoods = self.entropy_bottleneck(
            y, training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods}}

    @torch.inference_mode()
    def compress(self, x):
        y = run_transform(self.g_a, x)
        eb = self.entropy_bottleneck
        return {"strings": [eb.compress(y)], "shape": tuple(y.shape[1:3]),
                "y_hat": eb.quantize(y, "dequantize",
                                     eb._medians(tuple(y.shape)))}

    @torch.inference_mode()
    def decompress_y(self, strings, shape):
        if not (isinstance(strings, list) and len(strings) == 1):
            raise ValueError("expected [y strings]")
        return self.entropy_bottleneck.decompress(strings[0], tuple(shape))

    @torch.inference_mode()
    def decompress(self, strings, shape):
        return _decoded(self.g_s, self.decompress_y(strings, shape))


@register_model("bmshj2018-factorized-relu")
class FactorizedPriorReLU(FactorizedPrior):
    """GDN replaced by ReLU (google.py:168-205)."""

    def __init__(self, N, M, *, seed: int = 0, device="cuda", generator=None,
                 **kwargs):
        CompressionModel.__init__(self)
        g = _generator(seed, generator)
        self.entropy_bottleneck = EntropyBottleneck(M, generator=g)
        self.g_a = Sequential(
            conv(3, N, generator=g), ReLU(),
            conv(N, N, generator=g), ReLU(),
            conv(N, N, generator=g), ReLU(),
            conv(N, M, generator=g),
        )
        self.g_s = Sequential(
            deconv(M, N, generator=g), ReLU(),
            deconv(N, N, generator=g), ReLU(),
            deconv(N, N, generator=g), ReLU(),
            deconv(N, 3, generator=g),
        )
        self.N, self.M = int(N), int(M)
        self.to(device)


@register_model("bmshj2018-hyperprior")
class ScaleHyperprior(CompressionModel):
    """Scale hyperprior (google.py:206-337): z = h_a(|y|) models the scales
    of y."""

    def __init__(self, N, M, *, seed: int = 0, device="cuda", generator=None,
                 **kwargs):
        super().__init__()
        g = _generator(seed, generator)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.g_a = _gdn_g_a(N, M, g)
        self.g_s = _igdn_g_s(N, M, g)
        self.h_a = Sequential(
            conv(M, N, stride=1, kernel_size=3, generator=g), ReLU(),
            conv(N, N, generator=g), ReLU(),
            conv(N, N, generator=g),
        )
        self.h_s = Sequential(
            deconv(N, N, generator=g), ReLU(),
            deconv(N, N, generator=g), ReLU(),
            conv(N, M, stride=1, kernel_size=3, generator=g), ReLU(),
        )
        self.gaussian_conditional = GaussianConditional()
        self.N, self.M = int(N), int(M)
        self.to(device)

    @property
    def downsampling_factor(self) -> int:
        return 2 ** (4 + 2)

    def _hyper_input(self, y):
        return torch.abs(y)

    def forward(self, x, training: bool = True, generator=None):
        """{"x_hat" (not clamped), "likelihoods": {"y", "z"}}; the noise of
        z, then of y, from ``generator``."""
        y = self.g_a(x)
        z = self.h_a(self._hyper_input(y))
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        scales_hat = self.h_s(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def _compress_z(self, x):
        """(y, z strings, z's (H, W), h_s of the decoded z_hat on the rows
        chain)."""
        y = run_transform(self.g_a, x)
        z = run_transform(self.h_a, self._hyper_input(y))
        shape = tuple(z.shape[1:3])
        z_strings = self.entropy_bottleneck.compress(z)
        return y, z_strings, shape, self._side_params(z_strings, shape)

    def _side_params(self, z_strings, shape):
        z_hat = self.entropy_bottleneck.decompress(z_strings, tuple(shape))
        return run_canonical(self.h_s, z_hat)

    @torch.inference_mode()
    def compress(self, x):
        y, z_strings, shape, scales_hat = self._compress_z(x)
        gc = self.gaussian_conditional
        y_strings = gc.compress(y, gc.build_indexes(scales_hat))
        return {"strings": [y_strings, z_strings], "shape": shape,
                "y_hat": gc.quantize(y, "dequantize")}

    @torch.inference_mode()
    def decompress_y(self, strings, shape):
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        scales_hat = self._side_params(strings[1], shape)
        gc = self.gaussian_conditional
        return gc.decompress(strings[0], gc.build_indexes(scales_hat))

    @torch.inference_mode()
    def decompress(self, strings, shape):
        return _decoded(self.g_s, self.decompress_y(strings, shape))


@register_model("mbt2018-mean")
class MeanScaleHyperprior(ScaleHyperprior):
    """Mean-scale hyperprior (google.py:338-438). ``coder="table"`` codes y
    over the scale table; ``coder="search"`` codes it under each symbol's
    own Gaussian rows (FlashGMM's table-free search decoding), scales
    clipped to [0.11, 256], and puts ``abs_max`` in the compress dict,
    which ``decompress`` takes as a keyword."""

    def __init__(self, N, M, *, coder: str = "table", seed: int = 0,
                 device="cuda", generator=None, **kwargs):
        if coder not in ("table", "search"):
            raise ValueError(f"unknown coder {coder!r}")
        g = _generator(seed, generator)
        super().__init__(N, M, device="cpu", generator=g, **kwargs)
        self.coder = coder
        self.h_a = Sequential(
            conv(M, N, stride=1, kernel_size=3, generator=g), LeakyReLU(),
            conv(N, N, generator=g), LeakyReLU(),
            conv(N, N, generator=g),
        )
        self.h_s = Sequential(
            deconv(N, M, generator=g), LeakyReLU(),
            deconv(M, M * 3 // 2, generator=g), LeakyReLU(),
            conv(M * 3 // 2, M * 2, stride=1, kernel_size=3, generator=g),
        )
        self.to(device)

    def _hyper_input(self, y):
        return y

    def forward(self, x, training: bool = True, generator=None):
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        scales_hat, means_hat = torch.chunk(self.h_s(z_hat), 2, dim=-1)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, means_hat, training=training, generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def _gaussian_params(self, params):
        scales_hat, means_hat = torch.chunk(params, 2, dim=-1)
        if self.coder == "search":
            scales_hat = torch.clamp(scales_hat, 0.11, 256)
        return scales_hat, means_hat

    @torch.inference_mode()
    def compress(self, x):
        y, z_strings, shape, params = self._compress_z(x)
        scales_hat, means_hat = self._gaussian_params(params)
        gc = self.gaussian_conditional
        out = {"shape": shape, "y_hat": gc.quantize(y, "dequantize",
                                                    means_hat)}
        if self.coder == "search":
            y_strings, out["abs_max"] = gc.compress_search(y, scales_hat,
                                                           means_hat)
        else:
            y_strings = gc.compress(y, gc.build_indexes(scales_hat),
                                    means_hat)
        out["strings"] = [y_strings, z_strings]
        return out

    @torch.inference_mode()
    def decompress_y(self, strings, shape, abs_max=None):
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        scales_hat, means_hat = self._gaussian_params(
            self._side_params(strings[1], shape))
        gc = self.gaussian_conditional
        if self.coder == "search":
            if abs_max is None:
                raise ValueError('coder="search" decodes with the abs_max '
                                 "that compress returned")
            return gc.decompress_search(strings[0], scales_hat, abs_max,
                                        means_hat)
        return gc.decompress(strings[0], gc.build_indexes(scales_hat),
                             means=means_hat)

    @torch.inference_mode()
    def decompress(self, strings, shape, abs_max=None):
        return _decoded(self.g_s, self.decompress_y(strings, shape, abs_max))


@register_model("mbt2018")
class JointAutoregressiveHierarchicalPriors(MeanScaleHyperprior):
    """mbt2018: the mean-scale hyperprior with a PixelCNN spatial context
    (google.py:439-736). The dense training forward runs on the device;
    ``compress``/``decompress`` run the serial raster scan on the host
    (``runtime/rasterscan.py``), as the reference runs its per-pixel
    loop."""

    def __init__(self, N=192, M=192, *, seed: int = 0, device="cuda",
                 generator=None, **kwargs):
        g = _generator(seed, generator)
        super().__init__(N, M, device="cpu", generator=g, **kwargs)
        self.h_a = Sequential(
            conv(M, N, stride=1, kernel_size=3, generator=g), LeakyReLU(),
            conv(N, N, stride=2, kernel_size=5, generator=g), LeakyReLU(),
            conv(N, N, stride=2, kernel_size=5, generator=g),
        )
        self.h_s = Sequential(
            deconv(N, M, stride=2, kernel_size=5, generator=g), LeakyReLU(),
            deconv(M, M * 3 // 2, stride=2, kernel_size=5, generator=g),
            LeakyReLU(),
            conv(M * 3 // 2, M * 2, stride=1, kernel_size=3, generator=g),
        )
        self.entropy_parameters = Sequential(
            Conv2d(M * 12 // 3, M * 10 // 3, 1, generator=g), LeakyReLU(),
            Conv2d(M * 10 // 3, M * 8 // 3, 1, generator=g), LeakyReLU(),
            Conv2d(M * 8 // 3, M * 6 // 3, 1, generator=g),
        )
        self.context_prediction = MaskedConv2d(
            M, 2 * M, kernel_size=5, padding=2, stride=1, generator=g)
        self.to(device)

    def forward(self, x, training: bool = True, generator=None):
        """The noise of z, of y_hat, then of y's likelihoods from
        ``generator``."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        params = self.h_s(z_hat)
        gc = self.gaussian_conditional
        y_hat = gc.quantize(y, "noise" if training else "dequantize",
                            generator=generator)
        ctx_params = self.context_prediction(y_hat)
        gaussian_params = self.entropy_parameters(
            torch.cat([params, ctx_params], dim=-1))
        scales_hat, means_hat = torch.chunk(gaussian_params, 2, dim=-1)
        _, y_likelihoods = gc(y, scales_hat, means_hat, training=training,
                              generator=generator)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def _host_ar_pieces(self):
        return rasterscan.host_pieces(self.gaussian_conditional,
                                      self.context_prediction,
                                      self.entropy_parameters)

    @torch.inference_mode()
    def compress(self, x):
        """{"strings": [[y string an image], z strings], "shape", "y_hat"}."""
        y, z_strings, shape, params = self._compress_z(x)
        y_strings, y_hat = rasterscan.raster_scan_compress(
            y, params, self._host_ar_pieces())
        return {"strings": [y_strings, z_strings], "shape": shape,
                "y_hat": y_hat}

    @torch.inference_mode()
    def decompress_y(self, strings, shape, abs_max=None):
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        params = self._side_params(strings[1], shape)
        return rasterscan.raster_scan_decompress(
            strings[0], params, self._host_ar_pieces(),
            (shape[0] * 4, shape[1] * 4, self.M))
