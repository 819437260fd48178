"""Channel-conditional groups codec, Minnen2020 / ELIC's SCCTX (port of
flashgmm_tpu/latent_codecs/channel_groups.py): the latent is split into
uneven channel groups, coded in order, each group's parameters conditioned
on the groups before it through a channel-context network. All tensors
NHWC. In the reference format (:80-108) the channel contexts run on the
rows chain (``layers.run_canonical``).
"""

from itertools import accumulate

import torch
from torch import nn

from flashgmm_tpu_torch.layers import run_canonical
from flashgmm_tpu_torch.registry import register_module

from .base import LatentCodec


@register_module("ChannelGroupsLatentCodec")
class ChannelGroupsLatentCodec(LatentCodec):
    """``context_mode`` "all" conditions group k on every group before it;
    "first_and_last" on the first and the latest only (the Chandelier ELIC
    variant). ``channel_context`` holds "y1".."y{G-1}", ``latent_codec``
    "y0".."y{G-1}"."""

    def __init__(self, latent_codec=None, channel_context=None, *, groups,
                 context_mode: str = "all"):
        super().__init__()
        if context_mode not in ("all", "first_and_last"):
            raise ValueError(f"unknown context_mode {context_mode!r}")
        self.groups = [int(g) for g in groups]
        self.groups_acc = list(accumulate(self.groups, initial=0))
        self.context_mode = context_mode
        self.channel_context = nn.ModuleDict(dict(channel_context or {}))
        self.latent_codec = nn.ModuleDict(dict(latent_codec or {}))

    def _merge_y(self, y_hat_list):
        if self.context_mode == "first_and_last" and \
                1 < len(y_hat_list) < len(self.groups):
            return torch.cat([y_hat_list[0], y_hat_list[-1]], dim=-1)
        return torch.cat(y_hat_list, dim=-1)

    def _split(self, y):
        return [y[..., self.groups_acc[k]:self.groups_acc[k + 1]]
                for k in range(len(self.groups))]

    def _get_ctx_params(self, k, side_params, y_hat_, run=None):
        """Group k's parameters: the side parameters, after the channel
        context of the groups before it for k > 0. ``run(module, x)`` runs
        the context network (the codecs pass ``layers.run_canonical``);
        default ``module(x)``."""
        if k == 0:
            return side_params
        net = self.channel_context[f"y{k}"]
        ctx_in = self._merge_y(y_hat_[:k])
        ch_ctx = net(ctx_in) if run is None else run(net, ctx_in)
        return torch.cat([ch_ctx, side_params], dim=-1)

    def forward(self, y, side_params, training: bool = True, generator=None):
        """Each group through its latent codec in order (reference
        :59-82): {"likelihoods": {"y"}, "y_hat"}, both of y's shape."""
        y_ = self._split(y)
        y_hat_, y_lk_ = [], []
        for k in range(len(self.groups)):
            params = self._get_ctx_params(k, side_params, y_hat_)
            y_out = self.latent_codec[f"y{k}"](y_[k], params,
                                               training=training,
                                               generator=generator)
            y_hat_.append(y_out["y_hat"])
            y_lk_.append(y_out["likelihoods"]["y"])
        return {"likelihoods": {"y": torch.cat(y_lk_, dim=-1)},
                "y_hat": torch.cat(y_hat_, dim=-1)}

    def compress(self, y, side_params):
        """Each group's container strings in coding order, their shapes and
        the y_hat of all groups."""
        y_ = self._split(y)
        y_hat_, strings, shapes = [], [], []
        for k in range(len(self.groups)):
            params = self._get_ctx_params(k, side_params, y_hat_,
                                          run=run_canonical)
            y_out = self.latent_codec[f"y{k}"].compress(y_[k], params)
            y_hat_.append(y_out["y_hat"])
            strings.extend(y_out["strings"])
            shapes.append(y_out["shape"])
        return {"strings": strings, "shape": shapes,
                "y_hat": torch.cat(y_hat_, dim=-1)}

    def decompress(self, strings, shape, side_params):
        per_group = len(strings) // len(self.groups)
        y_hat_ = []
        for k in range(len(self.groups)):
            params = self._get_ctx_params(k, side_params, y_hat_,
                                          run=run_canonical)
            y_out = self.latent_codec[f"y{k}"].decompress(
                strings[per_group * k:per_group * (k + 1)], shape[k], params)
            y_hat_.append(y_out["y_hat"])
        return {"y_hat": torch.cat(y_hat_, dim=-1)}
