"""Density-preserving deep point-cloud compression (He2022 CVPR; port of
flashgmm_tpu/models/pointcloud/hrtzxf2022.py, CompressAI's models/
pointcloud/hrtzxf2022.py):

  encoder: 3 x DownsampleLayer (FPS to rate * n, the density estimate,
           point-transformer + position + density embeddings)
  latents: the features (an EntropyBottleneck) and the latent positions
           (a learned analysis / synthesis around an EntropyBottleneck, or
           raw float16)
  decoder: 3 x [UpsampleLayer (candidates from icosphere-direction
           mixtures) -> UpsampleNumLayer (local density) ->
           select_xyzs_and_feats (density-matching subsample) ->
           RefineLayer]

and the FoldingNet-style model (``folding-pcc-rec``). Built on the CPU from
a ``torch.Generator`` (``generator``, else one seeded with ``seed``), then
moved to ``device`` (the card unless the caller asks otherwise). Module
paths equal the JAX package's parameter paths (``zoo.load_npz``).

``compress`` and ``decompress`` run under the pinned library settings (no
TF32), so the caller's settings change neither the strings nor the
decoded cloud. The strings carry the EntropyBottleneck symbols, so another
device decodes them to the same symbols; the decoder's ``round`` of the
predicted point counts may land on the other side of .5 there and keep
another candidate, so clouds decoded on two devices are compared by
chamfer distance, not element by element.
"""

import numpy as np
import torch
from torch import nn

from flashgmm_tpu_torch.entropy_models import EntropyBottleneck
from flashgmm_tpu_torch.latent_codecs import EntropyBottleneckLatentCodec
from flashgmm_tpu_torch.layers import pinned_library_settings
from flashgmm_tpu_torch.layers.pointcloud import (
    DownsampleLayer,
    EdgeConv,
    PointNetSetMLP,
    RefineLayer,
    SharedMLP,
    UpsampleLayer,
    UpsampleNumLayer,
    nearby_distance_sum,
    select_xyzs_and_feats,
)
from flashgmm_tpu_torch.registry import register_model

from ..base import CompressionModel
from .sfu_pointnet import _PointNetFamily, _generator


class XyzsLatentCodec(nn.Module):
    """The latent positions' codec: a learned analysis / synthesis around
    an EntropyBottleneck (``mode="learned"``), or raw float16 bytes."""

    def __init__(self, dim, hidden_dim, k, ngroups=1, mode="learned",
                 conv_mode="mlp", *, generator=None):
        super().__init__()
        self.mode = mode
        # where the model was moved (the float16 mode has no parameter)
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)
        if mode == "learned":
            if conv_mode == "edge_conv":
                self.analysis = EdgeConv(3, dim, hidden_dim, k,
                                         generator=generator)
                self.synthesis = EdgeConv(dim, 3, hidden_dim, k,
                                          generator=generator)
            else:
                self.analysis = SharedMLP([3, hidden_dim, dim],
                                          final_act=False, generator=generator)
                self.synthesis = SharedMLP([dim, hidden_dim, 3],
                                           final_act=False, generator=generator)
            self.entropy_bottleneck = EntropyBottleneck(dim,
                                                        generator=generator)

    def forward(self, latent_xyzs, training=True, generator=None):
        if self.mode == "learned":
            z = self.analysis(latent_xyzs)
            z_hat, z_lk = self.entropy_bottleneck(
                z[:, :, None, :], training=training, generator=generator)
            return {"likelihoods": {"y": z_lk},
                    "y_hat": self.synthesis(z_hat[:, :, 0, :])}
        lk = torch.full(latent_xyzs.shape, 2.0 ** -16,
                        dtype=latent_xyzs.dtype, device=latent_xyzs.device)
        y_hat = latent_xyzs.to(torch.float16).to(torch.float32)
        return {"likelihoods": {"y": lk}, "y_hat": y_hat}

    def compress(self, latent_xyzs):
        if self.mode == "learned":
            z = self.analysis(latent_xyzs)[:, :, None, :]
            shape = tuple(z.shape[1:3])
            strings = self.entropy_bottleneck.compress(z)
            z_hat = self.entropy_bottleneck.decompress(strings, shape)
            return {"strings": [strings], "shape": shape,
                    "y_hat": self.synthesis(z_hat[:, :, 0, :])}
        z16 = latent_xyzs.to(torch.float16).cpu().numpy()
        strings = [z16[i].tobytes() for i in range(z16.shape[0])]
        y_hat = torch.from_numpy(z16.astype(np.float32)).to(latent_xyzs.device)
        return {"strings": [strings], "shape": tuple(latent_xyzs.shape[1:]),
                "y_hat": y_hat}

    def decompress(self, strings, shape):
        (z_strings,) = strings
        if self.mode == "learned":
            z_hat = self.entropy_bottleneck.decompress(z_strings, tuple(shape))
            return {"y_hat": self.synthesis(z_hat[:, :, 0, :])}
        arrs = [np.frombuffer(s, np.float16).reshape(shape).astype(np.float32)
                for s in z_strings]
        return {"y_hat": torch.from_numpy(np.stack(arrs)).to(
            self._anchor.device)}


class _Encoder(nn.Module):
    def __init__(self, downsample_rate, dim, hidden_dim, k, ngroups, *,
                 generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [DownsampleLayer(r, dim, hidden_dim, k, ngroups,
                             generator=generator) for r in downsample_rate])

    def forward(self, xyzs, feats):
        gt_xyzs_, gt_dnums_, gt_mdis_ = [], [], []
        for layer in self.layers:
            gt_xyzs_.append(xyzs)
            xyzs, feats, dnum, mdis = layer(xyzs, feats)
            gt_dnums_.append(dnum)
            gt_mdis_.append(mdis)
        return gt_xyzs_, gt_dnums_, gt_mdis_, xyzs, feats


class _Decoder(nn.Module):
    def __init__(self, downsample_rate, candidate_upsample_rate, dim,
                 hidden_dim, k, sub_point_conv_mode, compress_normal, *,
                 generator=None):
        super().__init__()
        g = generator
        self.k = k
        self.num_layers = len(downsample_rate)
        self.downsample_rate = list(downsample_rate)
        self.upsample_layers = nn.ModuleList(
            [UpsampleLayer(dim, hidden_dim, k, sub_point_conv_mode, u,
                           generator=g) for u in candidate_upsample_rate])
        self.upsample_num_layers = nn.ModuleList(
            [UpsampleNumLayer(dim, hidden_dim, u, generator=g)
             for u in candidate_upsample_rate])
        self.refine_layers = nn.ModuleList(
            [RefineLayer(dim, hidden_dim, k, sub_point_conv_mode,
                         compress_normal and i == self.num_layers - 1,
                         generator=g) for i in range(self.num_layers)])

    def forward(self, xyzs, feats, pred_mdis=True):
        """(xyzs_hat_, unums_hat_, mdis_hat_ or None, feats): the mean
        distances only with ``pred_mdis`` (the training forward's)."""
        latent_xyzs = xyzs
        xyzs_hat_, unums_hat_ = [], []
        for i in range(self.num_layers):
            cand_xyzs, cand_feats = self.upsample_layers[i](xyzs, feats)
            unum = self.upsample_num_layers[i](feats)
            rate = 1.0 / self.downsample_rate[self.num_layers - i - 1]
            xyzs, feats = select_xyzs_and_feats(cand_xyzs, cand_feats, unum,
                                                rate)
            xyzs, feats = self.refine_layers[i](xyzs, feats)
            xyzs_hat_.append(xyzs)
            unums_hat_.append(unum)
        mdis_hat_ = self._pred_mdis([latent_xyzs, *xyzs_hat_], unums_hat_) \
            if pred_mdis else None
        return xyzs_hat_, unums_hat_, mdis_hat_, feats

    def _pred_mdis(self, xyzs_hat_, unums_hat_):
        mdis_hat_ = []
        for prev, curr, unum in zip(xyzs_hat_[:-1], xyzs_hat_[1:], unums_hat_):
            distance, _, _, _ = nearby_distance_sum(prev, curr, self.k)
            mdis_hat_.append(distance / unum)
        return mdis_hat_


@register_model("hrtzxf2022-pcc-rec")
class DensityPreservingReconstructionPccModel(CompressionModel):
    """The density-preserving point-cloud codec. Input: ``{"pos": [b, n,
    3]}`` (and ``"normal"`` when ``compress_normal``) or a bare [b, n, 3]
    tensor."""

    def __init__(self, downsample_rate=(1 / 3, 1 / 3, 1 / 3),
                 candidate_upsample_rate=(8, 8, 8), in_dim=3, feat_dim=8,
                 hidden_dim=64, k=16, ngroups=1, sub_point_conv_mode="mlp",
                 compress_normal=False, latent_xyzs_codec=None, *,
                 seed: int = 0, device="cuda", generator=None, **kwargs):
        super().__init__()
        g = _generator(seed, generator)
        self.compress_normal = bool(compress_normal)
        self.pre_conv = SharedMLP([in_dim, hidden_dim, feat_dim],
                                  final_act=False, generator=g)
        self.encoder = _Encoder(downsample_rate, feat_dim, hidden_dim, k,
                                ngroups, generator=g)
        self.decoder = _Decoder(downsample_rate, candidate_upsample_rate,
                                feat_dim, hidden_dim, k, sub_point_conv_mode,
                                compress_normal, generator=g)
        self.latent_codec = nn.ModuleDict({
            "feat": EntropyBottleneckLatentCodec(channels=feat_dim,
                                                 generator=g),
            "xyz": XyzsLatentCodec(feat_dim, hidden_dim, k, ngroups,
                                   **(latent_xyzs_codec or {}), generator=g),
        })
        self.to(device)

    def _prepare_input(self, input):
        if isinstance(input, dict):
            xyzs = input["pos"]
            normals = input.get("normal") if self.compress_normal else None
        else:
            xyzs, normals = input, None
        feats = xyzs if normals is None else torch.cat([xyzs, normals], -1)
        return xyzs, normals, feats

    def forward(self, input, training: bool = True, generator=None):
        """The training forward (uniform noise from ``generator`` when
        ``training``). Both latent codecs quantize latents of one shape
        [b, m, 1, feat_dim] with the same noise, as the JAX model, which
        hands both the same key: the generator is rewound to draw the
        features' noise again for the latent positions, then left where
        the features' draw left it."""
        xyzs, gt_normals, feats = self._prepare_input(input)
        feats = self.pre_conv(feats)
        gt_xyzs_, gt_dnums_, gt_mdis_, latent_xyzs, latent_feats = (
            self.encoder(xyzs, feats))

        noisy = training and generator is not None
        state = generator.get_state() if noisy else None
        feats_out = self.latent_codec["feat"](
            latent_feats[:, :, None, :], training=training,
            generator=generator)
        latent_feats_hat = feats_out["y_hat"][:, :, 0, :]
        if noisy:
            after = generator.get_state()
            generator.set_state(state)
        xyzs_out = self.latent_codec["xyz"](latent_xyzs, training=training,
                                            generator=generator)
        if noisy:
            generator.set_state(after)
        latent_xyzs_hat = xyzs_out["y_hat"]

        xyzs_hat_, unums_hat_, mdis_hat_, feats_hat = self.decoder(
            latent_xyzs_hat, latent_feats_hat)
        return {
            "x_hat": xyzs_hat_[-1],
            "xyz_hat_": xyzs_hat_,
            "latent_xyz_hat": latent_xyzs_hat,
            "feat_hat": feats_hat,
            "upsample_num_hat_": unums_hat_,
            "mean_distance_hat_": mdis_hat_,
            "gt_xyz_": gt_xyzs_,
            "gt_latent_xyz": latent_xyzs,
            "gt_normal": gt_normals,
            "gt_downsample_num_": gt_dnums_,
            "gt_mean_distance_": gt_mdis_,
            "likelihoods": {
                "latent_feat": feats_out["likelihoods"]["y"],
                "latent_xyz": xyzs_out["likelihoods"]["y"],
            },
        }

    @torch.inference_mode()
    def compress(self, input):
        """{"strings": [feature strings, position strings], "shape":
        [their shapes]} (run ``update()`` first)."""
        with pinned_library_settings():
            xyzs, _, feats = self._prepare_input(input)
            _, _, _, latent_xyzs, latent_feats = self.encoder(
                xyzs, self.pre_conv(feats))
            feats_out = self.latent_codec["feat"].compress(
                latent_feats[:, :, None, :])
            xyzs_out = self.latent_codec["xyz"].compress(latent_xyzs)
        return {"strings": [feats_out["strings"], xyzs_out["strings"]],
                "shape": [feats_out["shape"], xyzs_out["shape"]]}

    @torch.inference_mode()
    def decompress(self, strings, shape):
        """{"x_hat" [b, n', 3], "feat_hat"} of compress's strings."""
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("expected [feature strings, position strings]")
        with pinned_library_settings():
            feats_hat = self.latent_codec["feat"].decompress(
                strings[0], shape[0])["y_hat"][:, :, 0, :]
            xyzs_hat = self.latent_codec["xyz"].decompress(
                strings[1], shape[1])["y_hat"]
            xyzs_hat_, _, _, feats_hat = self.decoder(xyzs_hat, feats_hat,
                                                      pred_mdis=False)
        return {"x_hat": xyzs_hat_[-1], "feat_hat": feats_hat}


class FoldingDecoder(nn.Module):
    """FoldingNet-style decoder: a fixed 2-D grid (a non-persistent
    buffer) deformed into 3-D, twice."""

    def __init__(self, latent_dim, num_points, *, generator=None):
        super().__init__()
        self.num_points = num_points
        side = int(np.ceil(np.sqrt(num_points)))
        u, v = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side))
        grid = np.stack([u.ravel(), v.ravel()], axis=-1)[:num_points]
        self.register_buffer("grid", torch.from_numpy(grid.astype(np.float32)),
                             persistent=False)
        self.fold1 = SharedMLP([latent_dim + 2, 256, 128, 3], final_act=False,
                               generator=generator)
        self.fold2 = SharedMLP([latent_dim + 3, 256, 128, 3], final_act=False,
                               generator=generator)

    def forward(self, latent):
        b = latent.shape[0]
        grid = self.grid[None].expand(b, self.num_points, 2)
        lat = latent[:, None, :].expand(b, self.num_points, latent.shape[-1])
        p1 = self.fold1(torch.cat([lat, grid], dim=-1))
        return self.fold2(torch.cat([lat, p1], dim=-1))


@register_model("folding-pcc-rec")
class FoldingPccModel(_PointNetFamily):
    """A PointNet encoder and a FoldingNet decoder."""

    def __init__(self, num_points: int = 1024, latent_dim: int = 512, *,
                 seed: int = 0, device="cuda", generator=None, **kwargs):
        CompressionModel.__init__(self)
        g = _generator(seed, generator)
        self.num_points = int(num_points)
        self.latent_dim = int(latent_dim)
        self.g_a = PointNetSetMLP([3, 64, 128, 256, latent_dim], generator=g)
        self.g_s = FoldingDecoder(latent_dim, num_points, generator=g)
        self.entropy_bottleneck = EntropyBottleneck(latent_dim, generator=g)
        self.to(device)

    def _encode_latent(self, points):
        return self.g_a(points["pos"] if isinstance(points, dict) else points)

    def _decode(self, y_hat, batch):
        return self.g_s(y_hat)


# the JAX package's name for the folding model
Hrtzxf2022PccModel = FoldingPccModel
