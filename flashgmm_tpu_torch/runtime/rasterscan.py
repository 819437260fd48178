"""Host raster scan of the PixelCNN-style context models, mbt2018 and
Cheng2020 (port of flashgmm_tpu/runtime/rasterscan.py).

The autoregressive chain is serial a latent position at a time, as in the
reference's per-pixel loop (CompressAI models/google.py:616-736). Encode and
decode both run each position's context math in numpy float32 with the same
op order (``window.reshape(-1) @ flat + bias``, ``v @ w + b``, the
LeakyReLU as ``np.where``, the scale-table loop), so the scale-table
indexes agree on both sides, and given the same ``y``, ``params`` and
weights the strings equal the JAX package's byte for byte. The symbols go
through the host coder's table path (``ans.cext``, the streaming decoder on
the way back). The dense training forward stays on the device.

The host pieces are built from the port's modules: the masked conv's
weight is ``MaskedConv2d.kernel_hwio()`` (masked, HWIO, float32) as
``[k*k*C, O]``, each 1x1 entropy-parameter conv ``weight[o, i, 0, 0]`` as
``[i, o]``, both C-contiguous as the JAX package's reshapes make them.

``vbr=`` takes the gain-scaled branch of the VBR model mbt2018-vbr
(``models/vbr.py``): a dict of ``scale`` and ``rescale`` (Python floats),
``ctx_scl`` (added to every position's context), ``offset_fn`` (the
quantization offsets of a position, numpy; None: no offsets) and
``scale_bound``. Each position's symbols are ``round((y - means) *
scale)``, coded under the table entry of ``scales * scale``, and its y_hat
is their reconstruction with the offsets (``_vbr_reconstruct``), with the
JAX package's numpy op order in both directions.
"""

import numpy as np
import torch

from flashgmm_tpu_torch.ans import RansEncoder, cext
from flashgmm_tpu_torch.layers import Conv2d


def _leaky_relu(x):
    return np.where(x >= 0, x, 0.01 * x)


def to_host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class HostEntropyParameters:
    """The 1x1-conv chain of an entropy-parameter network as numpy
    matmuls, each conv followed by a LeakyReLU but the last."""

    def __init__(self, ep_module):
        self.layers = []
        for layer in ep_module.layers:
            if isinstance(layer, Conv2d):
                w = to_host(layer.weight)  # [o, i, 1, 1]
                self.layers.append((np.ascontiguousarray(w[:, :, 0, 0].T),
                                    to_host(layer.bias)))
            else:
                self.layers.append(None)  # activation

    def __call__(self, v):
        for entry in self.layers:
            if entry is None:
                v = _leaky_relu(v)
            else:
                w, b = entry
                v = v @ w + b
        return v


class HostMaskedConv:
    """A k x k masked conv at one spatial position."""

    def __init__(self, conv_module):
        self.kernel = to_host(conv_module.kernel_hwio())  # [kh, kw, C, O]
        self.bias = to_host(conv_module.bias)
        kh, kw, c, o = self.kernel.shape
        self.k = kh
        self.flat = self.kernel.reshape(-1, o)

    def __call__(self, window):
        """window: [k, k, C] -> [O]."""
        return window.reshape(-1) @ self.flat + self.bias


def build_indexes_np(scales, scale_table, scale_bound):
    scales = np.maximum(scales, scale_bound)
    idx = np.full(scales.shape, len(scale_table) - 1, np.int32)
    for s in scale_table[:-1]:
        idx -= (scales <= s).astype(np.int32)
    return idx


def raster_scan_encode(y, params, ctx_conv, ep, gc_tables, scale_table,
                       scale_bound, vbr=None):
    """(string, y_hat [H, W, C]) of one image: y [H, W, C] and its hyper
    side parameters params [H, W, P], numpy float32. y_hat is
    ``round(y - means) + means`` position by position (with ``vbr``, the
    gain-scaled reconstruction), as the decoder reconstructs it."""
    h, w, c = y.shape
    pad = (ctx_conv.k - 1) // 2
    y_hat = np.zeros((h + 2 * pad, w + 2 * pad, c), np.float32)
    y_hat[pad:pad + h, pad:pad + w] = y

    cdfs, cdf_lengths, offsets = gc_tables
    symbols = np.empty(h * w * c, np.int32)
    indexes = np.empty(h * w * c, np.int32)
    n = 0
    for i in range(h):
        for j in range(w):
            window = y_hat[i:i + ctx_conv.k, j:j + ctx_conv.k]
            ctx = ctx_conv(window)
            if vbr is not None:
                ctx = ctx + vbr["ctx_scl"]
            gp = ep(np.concatenate([params[i, j], ctx]))
            scales_hat, means_hat = np.split(gp, 2)
            if vbr is None:
                idx = build_indexes_np(scales_hat, scale_table, scale_bound)
                y_q = np.round(y[i, j] - means_hat).astype(np.int32)
                y_hat[i + pad, j + pad] = y_q + means_hat
            else:
                s, rs = vbr["scale"], vbr["rescale"]
                idx = build_indexes_np(scales_hat * s, scale_table,
                                       scale_bound)
                y_q = np.round((y[i, j] - means_hat) * s).astype(np.int32)
                y_hat[i + pad, j + pad] = _vbr_reconstruct(
                    y_q, scales_hat, means_hat, s, rs, vbr)
            symbols[n:n + c] = y_q
            indexes[n:n + c] = idx
            n += c

    string = RansEncoder().encode_with_indexes(symbols, indexes, cdfs,
                                               cdf_lengths, offsets)
    return string, y_hat[pad:pad + h, pad:pad + w]


def raster_scan_compress_single_stream(y, params, ctx_conv, ep, gc_tables,
                                       scale_table, scale_bound, vbr=None):
    """y: [H, W, C] numpy; params: [H, W, P] hyper side parameters ->
    the encoded byte string."""
    return raster_scan_encode(y, params, ctx_conv, ep, gc_tables,
                              scale_table, scale_bound, vbr)[0]


def _vbr_reconstruct(y_q, scales_hat, means_hat, s, rs, vbr):
    """The gain-scaled reconstruction of one position's symbols, with the
    quantization offsets unless ``vbr["offset_fn"]`` is None."""
    offset_fn = vbr.get("offset_fn")
    q = y_q.astype(np.float32)
    if offset_fn is None:
        return q * rs + means_hat
    q_abs = np.abs(q)
    signs = np.sign(q)
    q_stdev = np.maximum(scales_hat * s, vbr["scale_bound"])
    q_off = offset_fn(q_stdev, s)
    q_off = np.where(q_abs < 1e-4, 0.0, q_off)
    return signs * (q_abs + q_off) * rs + means_hat


def raster_scan_decompress_single_stream(string, params, ctx_conv, ep,
                                         gc_tables, scale_table, scale_bound,
                                         shape, vbr=None):
    """Returns y_hat [H, W, C] numpy; shape = (H, W, C)."""
    h, w, c = shape
    pad = (ctx_conv.k - 1) // 2
    y_hat = np.zeros((h + 2 * pad, w + 2 * pad, c), np.float32)

    cdfs, cdf_lengths, offsets = gc_tables
    dec = cext.StreamingDecoder(string, cdfs, cdf_lengths, offsets)
    try:
        for i in range(h):
            for j in range(w):
                window = y_hat[i:i + ctx_conv.k, j:j + ctx_conv.k]
                ctx = ctx_conv(window)
                if vbr is not None:
                    ctx = ctx + vbr["ctx_scl"]
                gp = ep(np.concatenate([params[i, j], ctx]))
                scales_hat, means_hat = np.split(gp, 2)
                if vbr is None:
                    idx = build_indexes_np(scales_hat, scale_table,
                                           scale_bound)
                    rv = dec.decode(idx)
                    y_hat[i + pad, j + pad] = rv + means_hat
                else:
                    s, rs = vbr["scale"], vbr["rescale"]
                    idx = build_indexes_np(scales_hat * s, scale_table,
                                           scale_bound)
                    rv = dec.decode(idx)
                    y_hat[i + pad, j + pad] = _vbr_reconstruct(
                        rv.astype(np.float32), scales_hat, means_hat, s, rs,
                        vbr)
    finally:
        dec.close()
    return y_hat[pad:pad + h, pad:pad + w]


def raster_scan_compress(y, params, pieces, vbr=None):
    """[B, H, W, C] y and its [B, H, W, P] side parameters -> (one string
    an image, y_hat on y's device); each goes to the host once. ``pieces``:
    :func:`host_pieces`."""
    y_np, p_np = to_host(y), to_host(params)
    out = [raster_scan_encode(y_np[i], p_np[i], *pieces, vbr)
           for i in range(y_np.shape[0])]
    y_hat = torch.from_numpy(np.stack([o[1] for o in out])).to(y.device)
    return [o[0] for o in out], y_hat


def raster_scan_decompress(strings, params, pieces, shape, vbr=None):
    """One string an image -> y_hat [B, H, W, C] on the side parameters'
    device; shape = (H, W, C)."""
    p_np = to_host(params)
    y_hat = [raster_scan_decompress_single_stream(s, p_np[i], *pieces, shape,
                                                  vbr)
             for i, s in enumerate(strings)]
    return torch.from_numpy(np.stack(y_hat)).to(params.device)


def host_pieces(gaussian_conditional, context_prediction, entropy_parameters):
    """(masked conv, entropy parameters, (cdfs, cdf lengths, offsets), scale
    table, scale bound) for the loops above, each copied to the host once."""
    gc = gaussian_conditional
    gc._check_tables()
    return (HostMaskedConv(context_prediction),
            HostEntropyParameters(entropy_parameters),
            gc._tables(),
            to_host(gc.scale_table),
            gc.scale_bound)
