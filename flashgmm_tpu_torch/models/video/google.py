"""Scale-space flow video compression, ssf2020 (port of
flashgmm_tpu/models/video/google.py; CompressAI's
compressai/models/video/google.py:50-437). Frames are NHWC [N, H, W, 3]
with H and W multiples of 128 for coding (16 for the scale-space volume).

A keyframe branch and two inter branches (motion, residual), each a
mean-scale hyperprior (``_Hyperprior``). An inter frame is predicted by
warping a Gaussian scale-space volume of the reference frame with the
decoded (flow, scale) field: a trilinear ``F.grid_sample`` over the 5-D
volume [N, C, L, H, W] (bilinear, border padding, align_corners=False).
An out-of-range coordinate reads the edge sample, as the JAX package's
eight-corner gather does by clipping its integer indices, and the
gradients for the volume, the flow and the scale field are JAX's, but at a
coordinate lying exactly on an axis' first sample, where the border clip
gives a zero gradient and JAX a one-sided difference.

Reference-format coding (run ``update()`` first): the encoders, each
hyperprior's ``hyper_encoder`` and the frame decoders run as transforms
(``layers.run_transform``: float32, canonical strides, pinned library
settings), the prediction under the same settings, and each hyperprior's
scale and mean decoders, the entropy parameters, on the rows chain
(``layers.run_canonical``: the hand f32 conv kernel, each 5x5 stride-2
transposed conv zero-inserted; ``qrelu``'s clip after each conv of the
scale decoder). So on one device the decoder's frames equal the encoder's
reconstructions bit for bit across a GOP, and since every branch's
symbols depend on its strings alone, never on the reference frame, a
string coded on the card decodes on the CPU to the same y_hat of every
branch (``decompress_y``); the frames then agree within an atol.

Built on the CPU from a ``torch.Generator`` (``generator``, else one seeded
with ``seed``), then moved to ``device``. Module paths equal the JAX
package's parameter paths (``zoo.load_npz``).
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flashgmm_tpu_torch.entropy_models import (EntropyBottleneck,
                                               GaussianConditional)
from flashgmm_tpu_torch.layers import (ReLU, Sequential, conv, deconv,
                                       pinned_library_settings, qrelu,
                                       run_canonical, run_transform)
from flashgmm_tpu_torch.layers.layers import _library_input
from flashgmm_tpu_torch.ops import quantize_ste
from flashgmm_tpu_torch.registry import register_model

from ..base import CompressionModel


def _encoder(in_planes, g, mid=128, out=192):
    return Sequential(
        conv(in_planes, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        conv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        conv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        conv(mid, out, kernel_size=5, stride=2, generator=g),
    )


def _decoder(out_planes, g, in_planes=192, mid=128):
    return Sequential(
        deconv(in_planes, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        deconv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        deconv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
        deconv(mid, out_planes, kernel_size=5, stride=2, generator=g),
    )


class _HyperDecoderQReLU(nn.Module):
    """Three 5x5 stride-2 deconvs, each followed by ``qrelu``."""

    def __init__(self, g, planes=192, mid=192):
        super().__init__()
        self.deconv1 = deconv(planes, mid, kernel_size=5, stride=2,
                              generator=g)
        self.deconv2 = deconv(mid, mid, kernel_size=5, stride=2, generator=g)
        self.deconv3 = deconv(mid, planes, kernel_size=5, stride=2,
                              generator=g)

    def _deconvs(self):
        return (self.deconv1, self.deconv2, self.deconv3)

    def forward(self, x):
        for d in self._deconvs():
            x = qrelu(d(x))
        return x

    def canonical(self, x):
        """The rows-chain forward: each deconv on the hand conv kernel,
        then the clip."""
        for d in self._deconvs():
            x = qrelu(d.canonical(x))
        return x


class _Hyperprior(CompressionModel):
    """A mean-scale hyperprior over a 192-channel latent: y is coded around
    the means the mean decoder gives, under the scales of the qrelu scale
    decoder."""

    def __init__(self, g, planes=192, mid=192):
        super().__init__()
        self.entropy_bottleneck = EntropyBottleneck(mid, generator=g)
        self.hyper_encoder = Sequential(
            conv(planes, mid, kernel_size=5, stride=2, generator=g), ReLU(),
            conv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
            conv(mid, mid, kernel_size=5, stride=2, generator=g),
        )
        self.hyper_decoder_mean = Sequential(
            deconv(planes, mid, kernel_size=5, stride=2, generator=g), ReLU(),
            deconv(mid, mid, kernel_size=5, stride=2, generator=g), ReLU(),
            deconv(mid, planes, kernel_size=5, stride=2, generator=g),
        )
        self.hyper_decoder_scale = _HyperDecoderQReLU(g, planes, mid)
        self.gaussian_conditional = GaussianConditional()

    def forward(self, y, training: bool = True, generator=None):
        """(y_hat, {"y", "z"} likelihoods); the noise of z, then of y's
        likelihoods, from ``generator``; y_hat is rounded around the means
        with a straight-through gradient, in training too."""
        z = self.hyper_encoder(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        scales = self.hyper_decoder_scale(z_hat)
        means = self.hyper_decoder_mean(z_hat)
        _, y_likelihoods = self.gaussian_conditional(
            y, scales, means, training=training, generator=generator)
        y_hat = quantize_ste(y - means) + means
        return y_hat, {"y": y_likelihoods, "z": z_likelihoods}

    def _side_params(self, z_strings, shape):
        """(scales, means) of the decoded z_hat, on the rows chain."""
        z_hat = self.entropy_bottleneck.decompress(z_strings, tuple(shape))
        return (run_canonical(self.hyper_decoder_scale, z_hat),
                run_canonical(self.hyper_decoder_mean, z_hat))

    def compress(self, y):
        """(y_hat, {"strings": [y strings, z strings], "shape": z's (H,
        W)})."""
        z = run_transform(self.hyper_encoder, y)
        shape = tuple(z.shape[1:3])
        z_strings = self.entropy_bottleneck.compress(z)
        scales, means = self._side_params(z_strings, shape)
        gc = self.gaussian_conditional
        y_strings = gc.compress(y, gc.build_indexes(scales), means)
        y_hat = gc.quantize(y, "dequantize", means)
        return y_hat, {"strings": [y_strings, z_strings], "shape": shape}

    def decompress(self, strings, shape):
        """y_hat of compress's strings and shape."""
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [y strings, z strings]")
        scales, means = self._side_params(strings[1], shape)
        gc = self.gaussian_conditional
        return gc.decompress(strings[0], gc.build_indexes(scales),
                             means=means)


@lru_cache(maxsize=None)
def _gaussian_taps(k: int, sigma: float) -> np.ndarray:
    x = np.arange(k, dtype=np.float32) - (k - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def gaussian_kernel1d(k, sigma, device=None):
    """The normalised 1-d Gaussian of k taps (float32, the JAX package's
    numpy arithmetic)."""
    return torch.from_numpy(_gaussian_taps(int(k), float(sigma))).to(device)


def _blur_nchw(x, sigma):
    """Depthwise separable Gaussian blur of an NCHW tensor, zero-padded
    "same", k = 2 * ceil(3 * sigma) + 1 taps."""
    k = 2 * int(math.ceil(3 * sigma)) + 1
    c = x.shape[1]
    g = gaussian_kernel1d(k, sigma, x.device).to(x.dtype)
    pad = k // 2
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), padding=(pad, 0),
                 groups=c)
    return F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k),
                    padding=(0, pad), groups=c)


def _nchw(x):
    """NHWC x as the blur's NCHW input (``layers._library_input``: a
    channels-last view, a contiguous copy where autograd records a CPU
    conv)."""
    return _library_input(x, x)


def gaussian_blur(x, sigma):
    """Separable Gaussian blur of NHWC x (zero padding, "same")."""
    return _blur_nchw(_nchw(x), sigma).permute(0, 2, 3, 1)


def _volume_ncdhw(x_nchw, sigma, num_levels):
    """[N, C, H, W] -> the scale-space volume [N, C, L, H, W], L =
    num_levels + 1: the frame, its blur, then level i (1 <= i < num_levels)
    the blurred level before it average-pooled 2x2 and blurred, upsampled
    by 2 i times in a row."""
    volume = [x_nchw]
    cur = _blur_nchw(x_nchw, sigma)
    volume.append(cur)
    for i in range(1, num_levels):
        cur = _blur_nchw(F.avg_pool2d(cur, 2), sigma)
        interp = cur
        for _ in range(i):
            interp = F.interpolate(interp, scale_factor=2, mode="bilinear",
                                   align_corners=False)
        volume.append(interp)
    return torch.stack(volume, dim=2)


def _warp_ncdhw(volume, flow, scale_field):
    """Trilinear sample of volume [N, C, L, H, W] at the identity grid
    moved by flow [N, H, W, 2] (normalised x, y) and at the depth
    scale_field [N, H, W, 1] (normalised): NHWC [N, H, W, C]."""
    n, _, _, h, w = volume.shape
    dev, dt = flow.device, flow.dtype
    gx = (torch.arange(w, dtype=dt, device=dev) + 0.5) * 2 / w - 1
    gy = (torch.arange(h, dtype=dt, device=dev) + 0.5) * 2 / h - 1
    grid = torch.stack([gx[None, None, :] + flow[..., 0],
                        gy[None, :, None] + flow[..., 1],
                        scale_field[..., 0]], dim=-1)
    out = F.grid_sample(volume, grid[:, None], mode="bilinear",
                        padding_mode="border", align_corners=False)
    return out[:, :, 0].permute(0, 2, 3, 1)


@register_model("ssf2020")
class ScaleSpaceFlow(CompressionModel):
    """ssf2020 (Agustsson et al. 2020), its published widths: encoders of
    128 channels to a 192-channel latent, hyperpriors of 192."""

    def __init__(self, num_levels: int = 5, sigma0: float = 1.5,
                 scale_field_shift: float = 1.0, *, seed: int = 0,
                 device="cuda", generator=None, **kwargs):
        super().__init__()
        g = generator if generator is not None \
            else torch.Generator().manual_seed(int(seed))
        self.img_encoder = _encoder(3, g)
        self.img_decoder = _decoder(3, g)
        self.img_hyperprior = _Hyperprior(g)

        self.res_encoder = _encoder(3, g)
        self.res_decoder = _decoder(3, g, in_planes=384)
        self.res_hyperprior = _Hyperprior(g)

        self.motion_encoder = _encoder(2 * 3, g)
        self.motion_decoder = _decoder(2 + 1, g)
        self.motion_hyperprior = _Hyperprior(g)

        self.sigma0 = sigma0
        self.num_levels = num_levels
        self.scale_field_shift = scale_field_shift
        self.to(device)

    # -- scale-space prediction --------------------------------------------

    def gaussian_volume(self, x, sigma: float, num_levels: int):
        """NHWC [N, H, W, C] -> the volume [N, L, H, W, C] (the JAX
        package's layout)."""
        v = _volume_ncdhw(_nchw(x), sigma, num_levels)
        return v.permute(0, 2, 3, 4, 1)

    def warp_volume(self, volume, flow, scale_field):
        """volume [N, L, H, W, C] sampled at the flow [N, H, W, 2] and the
        scale field [N, H, W, 1]: [N, H, W, C]."""
        return _warp_ncdhw(volume.permute(0, 4, 1, 2, 3), flow, scale_field)

    def forward_prediction(self, x_ref, motion_info):
        """x_ref [N, H, W, 3] warped by motion_info [N, H, W, 3] (flow x,
        flow y, scale)."""
        volume = _volume_ncdhw(_nchw(x_ref), self.sigma0, self.num_levels)
        return _warp_ncdhw(volume, motion_info[..., :2], motion_info[..., 2:])

    # -- the training forward ----------------------------------------------

    def forward_keyframe(self, x, training=True, generator=None):
        y = self.img_encoder(x)
        y_hat, likelihoods = self.img_hyperprior(
            y, training=training, generator=generator)
        return self.img_decoder(y_hat), {"keyframe": likelihoods}

    def forward_inter(self, x_cur, x_ref, training=True, generator=None):
        y_motion = self.motion_encoder(torch.cat([x_cur, x_ref], dim=-1))
        y_motion_hat, motion_lk = self.motion_hyperprior(
            y_motion, training=training, generator=generator)
        x_pred = self.forward_prediction(x_ref,
                                         self.motion_decoder(y_motion_hat))

        y_res = self.res_encoder(x_cur - x_pred)
        y_res_hat, res_lk = self.res_hyperprior(
            y_res, training=training, generator=generator)

        y_combine = torch.cat([y_res_hat, y_motion_hat], dim=-1)
        x_rec = x_pred + self.res_decoder(y_combine)
        return x_rec, {"motion": motion_lk, "residual": res_lk}

    def forward(self, frames, training: bool = True, generator=None):
        """frames: a list of [N, H, W, 3] -> {"x_hat": [frame, ...] (not
        clamped), "likelihoods": [{"keyframe": {"y", "z"}}, {"motion": ...,
        "residual": ...}, ...]}. Training noise from ``generator``, frame by
        frame. Only the keyframe's reconstruction is cut from the gradient
        as a reference; later references keep theirs."""
        if not isinstance(frames, (list, tuple)):
            raise RuntimeError("Expected a list of frames")
        x_hat, lk = self.forward_keyframe(frames[0], training, generator)
        reconstructions, frames_likelihoods = [x_hat], [lk]
        x_ref = x_hat.detach()
        for x in frames[1:]:
            x_ref, lk = self.forward_inter(x, x_ref, training, generator)
            reconstructions.append(x_ref)
            frames_likelihoods.append(lk)
        return {"x_hat": reconstructions, "likelihoods": frames_likelihoods}

    # -- reference-format coding -------------------------------------------

    def _predict(self, x_ref, motion_info):
        with pinned_library_settings():
            return self.forward_prediction(x_ref, motion_info)

    def encode_keyframe(self, x):
        """(the reconstruction, {"strings", "shape"}, {"keyframe": y_hat})."""
        y_hat, out = self.img_hyperprior.compress(
            run_transform(self.img_encoder, x))
        return run_transform(self.img_decoder, y_hat), out, \
            {"keyframe": y_hat}

    def decode_keyframe(self, strings, shape):
        """(the frame, {"keyframe": y_hat})."""
        y_hat = self.img_hyperprior.decompress(strings, shape)
        return run_transform(self.img_decoder, y_hat), {"keyframe": y_hat}

    def encode_inter(self, x_cur, x_ref):
        """(the reconstruction, {"strings", "shape"} of each branch, the
        branches' y_hat)."""
        y_motion = run_transform(self.motion_encoder,
                                 torch.cat([x_cur, x_ref], dim=-1))
        y_motion_hat, out_motion = self.motion_hyperprior.compress(y_motion)
        x_pred = self._predict(x_ref, run_transform(self.motion_decoder,
                                                    y_motion_hat))

        y_res = run_transform(self.res_encoder, x_cur - x_pred)
        y_res_hat, out_res = self.res_hyperprior.compress(y_res)

        y_combine = torch.cat([y_res_hat, y_motion_hat], dim=-1)
        x_rec = x_pred + run_transform(self.res_decoder, y_combine)
        return x_rec, {
            "strings": {"motion": out_motion["strings"],
                        "residual": out_res["strings"]},
            "shape": {"motion": out_motion["shape"],
                      "residual": out_res["shape"]},
        }, {"motion": y_motion_hat, "residual": y_res_hat}

    def decode_inter(self, x_ref, strings, shapes):
        """(the frame, the branches' y_hat)."""
        y_motion_hat = self.motion_hyperprior.decompress(strings["motion"],
                                                         shapes["motion"])
        x_pred = self._predict(x_ref, run_transform(self.motion_decoder,
                                                    y_motion_hat))
        y_res_hat = self.res_hyperprior.decompress(strings["residual"],
                                                   shapes["residual"])
        y_combine = torch.cat([y_res_hat, y_motion_hat], dim=-1)
        return x_pred + run_transform(self.res_decoder, y_combine), {
            "motion": y_motion_hat, "residual": y_res_hat}

    @torch.inference_mode()
    def compress(self, frames, details: bool = False):
        """A GOP (frame 0 the keyframe) -> (strings, shapes), a frame each.
        With ``details``, also {"x_hat": the encoder's reconstructions,
        "y_hat": each frame's branches' y_hat}."""
        x_ref, out, y_hat = self.encode_keyframe(frames[0])
        strings, shapes = [out["strings"]], [out["shape"]]
        x_recs, y_hats = [x_ref], [y_hat]
        for x in frames[1:]:
            x_ref, out, y_hat = self.encode_inter(x, x_ref)
            strings.append(out["strings"])
            shapes.append(out["shape"])
            x_recs.append(x_ref)
            y_hats.append(y_hat)
        if details:
            return strings, shapes, {"x_hat": x_recs, "y_hat": y_hats}
        return strings, shapes

    @torch.inference_mode()
    def decompress(self, strings, shapes, details: bool = False):
        """The GOP's frames (not clamped) of compress's strings and
        shapes. With ``details``, also {"y_hat": each frame's branches'
        y_hat}."""
        x_ref, y_hat = self.decode_keyframe(strings[0], shapes[0])
        dec_frames, y_hats = [x_ref], [y_hat]
        for s, shape in zip(strings[1:], shapes[1:]):
            x_ref, y_hat = self.decode_inter(x_ref, s, shape)
            dec_frames.append(x_ref)
            y_hats.append(y_hat)
        if details:
            return dec_frames, {"y_hat": y_hats}
        return dec_frames

    @torch.inference_mode()
    def decompress_y(self, strings, shapes):
        """Each frame's branches' y_hat of compress's strings and shapes
        ({"keyframe"}, then {"motion", "residual"}), without the frames:
        they depend on the strings alone."""
        out = [{"keyframe": self.img_hyperprior.decompress(strings[0],
                                                           shapes[0])}]
        for s, shape in zip(strings[1:], shapes[1:]):
            out.append({
                "motion": self.motion_hyperprior.decompress(
                    s["motion"], shape["motion"]),
                "residual": self.res_hyperprior.decompress(
                    s["residual"], shape["residual"])})
        return out
