"""Model-card exporter for the standalone C++ codec (csrc/standalone/; port
of flashgmm_tpu/standalone/export.py).

The card serializes the layer stacks directly (they are straight-line
conv programs) together with the model's own EntropyBottleneck tables,
built by ``model.update()``: the same tables every other coding path of
the package uses.

Card format "FGSAM001" (little-endian; reader: csrc/standalone/common.h):

    magic[8]
    latent_channels:i32  down:i32
    g_a: n_layers:i32, then per layer:
        type:i32 (0 conv | 1 deconv | 2 gdn | 3 igdn | 4 relu | 5 leaky)
        conv/deconv: kh kw in out stride pad outpad :i32,
                     kernel f32[kh*kw*in*out] (HWIO), bias f32[out]
        gdn/igdn:    C:i32, beta f32[C], gamma f32[C*C] ([out, in])
        leaky:       slope f32
    g_s: same
    cdf_stride:i32, cdfs i32[M*stride], cdf_lengths i32[M],
    offsets i32[M], medians f32[M], gains f32[M]

The port keeps torch's layouts (conv weights OIHW, transposed convs
[in, out, kh, kw]); the card's kernels are HWIO, so they are transposed
back here.
"""

import struct

import numpy as np
import torch

from flashgmm_tpu_torch.layers import (GDN, Conv2d, ConvTranspose2d,
                                       LeakyReLU, ReLU, Sequential,
                                       run_transform)

from .format import _eb_tables

_MAGIC = b"FGSAM001"


def _pack_i32(*vals):
    return struct.pack("<" + "i" * len(vals), *vals)


def _pack_f32(arr):
    return np.ascontiguousarray(arr, np.float32).tobytes()


def _f32(t):
    return t.detach().float().cpu().numpy()


def _layer_record(layer):
    if isinstance(layer, (Conv2d, ConvTranspose2d)):
        is_deconv = isinstance(layer, ConvTranspose2d)
        w = _f32(layer.weight)
        # OIHW -> HWIO; a transposed conv's [in, out, kh, kw] -> HWIO
        kernel = np.transpose(w, (2, 3, 0, 1) if is_deconv else (2, 3, 1, 0))
        kh, kw, in_ch, out_ch = kernel.shape
        sh, sw = layer.stride
        ph, pw = layer.padding
        if kh != kw or sh != sw or ph != pw:
            raise ValueError("standalone export supports square convs only")
        op = layer.output_padding[0] if is_deconv else 0
        if is_deconv and layer.output_padding[0] != layer.output_padding[1]:
            raise ValueError("standalone export: asymmetric output padding")
        bias = (_f32(layer.bias) if layer.bias is not None
                else np.zeros((out_ch,), np.float32))
        rec = _pack_i32(1 if is_deconv else 0, kh, kw, in_ch, out_ch, sh, ph,
                        op)
        return rec + _pack_f32(kernel) + _pack_f32(bias)
    if isinstance(layer, GDN):
        with torch.no_grad():
            beta = _f32(layer.beta_reparam(layer.beta))
            gamma = _f32(layer.gamma_reparam(layer.gamma))
        rec = _pack_i32(3 if layer.inverse else 2, beta.shape[0])
        return rec + _pack_f32(beta) + _pack_f32(gamma)
    # ReLU is the port's LeakyReLU of slope 0: test it first
    if isinstance(layer, ReLU):
        return _pack_i32(4)
    if isinstance(layer, LeakyReLU):
        return _pack_i32(5) + struct.pack("<f", float(layer.negative_slope))
    raise ValueError(
        f"standalone export: unsupported layer {type(layer).__name__} "
        "(conv/deconv/GDN/ReLU/LeakyReLU stacks only)")


def _stack_records(seq: Sequential) -> bytes:
    layers = list(seq)
    return _pack_i32(len(layers)) + b"".join(_layer_record(l) for l in layers)


def synthesis_gains(model, latent_hw: int = 8, chunk: int = 16) -> np.ndarray:
    """Per-channel synthesis energy: ``||g_s(base + e_c) - g_s(base)||^2``
    for a centered unit impulse in channel c around the median latent, g_s
    run on the model's device in float32 (``layers.run_transform``).

    Feeds the C++ encoder's latent-space RDOQ (csrc/standalone/codec.h);
    replaces the reference rdoq.h's per-candidate decoder runs with a
    one-time Jacobian-style probe. Finite step of 1.0 = the actual
    quantization step.
    """
    dev = model.entropy_bottleneck.quantiles.device
    medians = torch.from_numpy(_eb_tables(model)[3]).to(dev)
    m_ch = medians.shape[0]
    base = medians[None, None, None, :].expand(1, latent_hw, latent_hw, m_ch)
    with torch.inference_mode():
        x0 = run_transform(model.g_s, base)
        cy = latent_hw // 2
        gains = np.empty((m_ch,), np.float32)
        for lo in range(0, m_ch, chunk):
            hi = min(lo + chunk, m_ch)
            batch = base.repeat(hi - lo, 1, 1, 1)
            batch[:, cy, cy, :] += torch.eye(m_ch, device=dev)[lo:hi]
            d = run_transform(model.g_s, batch) - x0
            gains[lo:hi] = (d * d).sum(dim=(1, 2, 3)).cpu().numpy()
    return gains


def export_model_card(model, path: str, *, compute_gains: bool = True) -> int:
    """Write the standalone model card for a factorized-prior model.

    The model must expose ``g_a``/``g_s`` Sequential stacks of
    conv/deconv/GDN/ReLU layers and an ``entropy_bottleneck`` with built
    tables (call ``model.update()`` first). Returns bytes written.
    """
    cdfs, cdf_lengths, offsets, medians = _eb_tables(model)
    if cdfs.size == 0:
        raise ValueError(
            "EntropyBottleneck tables empty — run model.update()")
    m_ch = int(cdfs.shape[0])
    gains = (synthesis_gains(model) if compute_gains
             else np.ones((m_ch,), np.float32))

    down = int(getattr(model, "downsampling_factor", 16))
    blob = (
        _MAGIC
        + _pack_i32(m_ch, down)
        + _stack_records(model.g_a)
        + _stack_records(model.g_s)
        + _pack_i32(int(cdfs.shape[1]))
        + np.ascontiguousarray(cdfs, np.int32).tobytes()
        + np.ascontiguousarray(cdf_lengths, np.int32).tobytes()
        + np.ascontiguousarray(offsets, np.int32).tobytes()
        + _pack_f32(medians)
        + _pack_f32(gains)
    )
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
