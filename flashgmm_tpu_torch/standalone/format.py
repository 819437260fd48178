"""Python twin of the standalone bitstream ("FGSAB001"; port of
flashgmm_tpu/standalone/format.py).

Byte-compatible with csrc/standalone/codec.h: streams produced here decode
with the C++ ``fgsc_decode`` binary and vice versa (the body is the same
table-rANS format both the C++ standalone codec and the port's host coder
``ans/cext.py`` emit: csrc/rans.cpp). g_a and g_s run on the model's
device (``layers.run_transform``: float32, canonical strides, pinned
library settings).

Layout (little-endian):
    magic[8]="FGSAB001" | w:u16 h:u16 M:u16 | down:u8 flags:u8
    | bitmap: ceil(M/8) bytes (bit k = channel k coded)
    | body_len:u32 | body
Body symbols: active channels ascending, channel-major, row-major spatial,
index = channel id, coded with the EntropyBottleneck tables.
"""

import struct

import numpy as np
import torch

from flashgmm_tpu_torch.ans import cext
from flashgmm_tpu_torch.layers import run_transform

_MAGIC = b"FGSAB001"


def _eb_tables(model):
    eb = model.entropy_bottleneck
    cdfs = eb.quantized_cdf.cpu().numpy().astype(np.int32)
    lengths = eb.cdf_length.cpu().numpy().astype(np.int32).ravel()
    offsets = eb.offset.cpu().numpy().astype(np.int32).ravel()
    medians = eb._get_medians()[:, 0, 0].detach().float().cpu().numpy()
    return cdfs, lengths, offsets, medians


def _down(model) -> int:
    return int(getattr(model, "downsampling_factor", 16))


def replicate_pad(x: np.ndarray, multiple: int) -> np.ndarray:
    """Pad [H, W, C] to a size multiple with edge replication (matches the
    C++ encoder's image_to_tensor padding)."""
    h, w = x.shape[:2]
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    return np.pad(x, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")


def pack_bitstream(symbols: np.ndarray, model, img_w: int,
                   img_h: int) -> bytes:
    """Pack integer symbols [Hl, Wl, M] (= round(y - median)) into a
    standalone bitstream."""
    cdfs, lengths, offsets, _ = _eb_tables(model)
    m_ch = int(cdfs.shape[0])
    hl, wl, c = symbols.shape
    if c != m_ch:
        raise ValueError(f"symbols C={c} != model latent channels {m_ch}")

    sym_cm = np.ascontiguousarray(
        np.transpose(symbols.astype(np.int32), (2, 0, 1)))  # [C, H, W]
    active = np.any(sym_cm != 0, axis=(1, 2))
    act_idx = np.nonzero(active)[0]
    flat_syms = sym_cm[act_idx].reshape(-1)
    flat_idx = np.repeat(act_idx.astype(np.int32), hl * wl)
    body = (cext.encode_with_indexes(flat_syms, flat_idx, cdfs, lengths,
                                     offsets)
            if flat_syms.size else b"")

    bitmap = np.packbits(active.astype(np.uint8), bitorder="little").tobytes()
    header = (_MAGIC
              + struct.pack("<HHHBB", img_w, img_h, m_ch, _down(model), 1)
              + bitmap + struct.pack("<I", len(body)))
    return header + body


def unpack_bitstream(data: bytes, model):
    """Parse a standalone bitstream -> (symbols [Hl, Wl, M], img_w, img_h)."""
    if data[:8] != _MAGIC:
        raise ValueError("bad standalone bitstream magic")
    img_w, img_h, m_ch, down, flags = struct.unpack_from("<HHHBB", data, 8)
    cdfs, lengths, offsets, _ = _eb_tables(model)
    if m_ch != cdfs.shape[0]:
        raise ValueError("bitstream/model channel mismatch")
    if down != _down(model):
        raise ValueError(
            f"bitstream downsampling {down} != model's {_down(model)}")
    if flags != 1:
        raise ValueError(f"unknown bitstream flags {flags}")
    nbm = (m_ch + 7) // 8
    bitmap = np.unpackbits(np.frombuffer(data, np.uint8, nbm, 16),
                           bitorder="little")[:m_ch].astype(bool)
    (body_len,) = struct.unpack_from("<I", data, 16 + nbm)
    body = data[16 + nbm + 4: 16 + nbm + 4 + body_len]

    hl = (img_h + down - 1) // down
    wl = (img_w + down - 1) // down
    sym_cm = np.zeros((m_ch, hl, wl), np.int32)
    act_idx = np.nonzero(bitmap)[0]
    if act_idx.size:
        flat_idx = np.repeat(act_idx.astype(np.int32), hl * wl)
        decoded = cext.decode_with_indexes(body, flat_idx, cdfs, lengths,
                                           offsets)
        sym_cm[act_idx] = np.asarray(decoded, np.int32).reshape(-1, hl, wl)
    return np.transpose(sym_cm, (1, 2, 0)), img_w, img_h


def encode_symbols(model, image: np.ndarray):
    """An [H, W, 3] float image in [0, 1] (or uint8) through g_a on the
    model's device -> (symbols [Hl, Wl, M] int32, img_w, img_h)."""
    x = np.asarray(image)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    img_h, img_w = x.shape[:2]
    xp = replicate_pad(x.astype(np.float32), _down(model))
    dev = model.entropy_bottleneck.quantiles.device
    with torch.inference_mode():
        y = run_transform(model.g_a, torch.from_numpy(xp)[None].to(dev))
    y = y[0].cpu().numpy()
    _, _, _, medians = _eb_tables(model)
    # round-half-away-from-zero, matching the C++ encoder (codec.h)
    rel = y - medians[None, None, :]
    symbols = np.sign(rel) * np.floor(np.abs(rel) + 0.5)
    return symbols.astype(np.int32), img_w, img_h


def encode_bitstream(model, image: np.ndarray) -> bytes:
    """Encode an [H, W, 3] float image in [0, 1] (or uint8) through the
    port's g_a into a standalone bitstream."""
    symbols, img_w, img_h = encode_symbols(model, image)
    return pack_bitstream(symbols, model, img_w, img_h)


def decode_bitstream(model, data: bytes) -> np.ndarray:
    """Decode a standalone bitstream through the port's g_s -> [H, W, 3]
    float in [0, 1]."""
    symbols, img_w, img_h = unpack_bitstream(data, model)
    _, _, _, medians = _eb_tables(model)
    y_hat = symbols.astype(np.float32) + medians[None, None, :]
    dev = model.entropy_bottleneck.quantiles.device
    with torch.inference_mode():
        x_hat = run_transform(model.g_s, torch.from_numpy(y_hat)[None].to(dev))
    x_hat = x_hat[0].cpu().numpy()
    return np.clip(x_hat[:img_h, :img_w], 0.0, 1.0)
