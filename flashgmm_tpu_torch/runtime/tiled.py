"""Spatially-tiled synthesis for high-resolution decoding (port of
flashgmm_tpu/runtime/tiled.py).

At 2K+ the g_s activation pyramid dominates decode memory (the last
upsample stage holds H x W x 192 per image at full resolution). Tiling the
latent along H bounds it by the tile: each tile of ``tile_h`` latent rows
runs g_s with ``halo`` rows of context on each side, and only its core
rows of output are kept.

Exactness: every output pixel of a tile sees the full receptive field of
g_s as long as the halo covers it. For the flagship g_s (RB, 3x(RBU+RB),
subpel: 3x3 convs at 1x/2x/4x/8x latent resolution) the receptive field
is < 7 latent rows per side; HALO=8 is safe. What is left is the library's
choice of algorithm by shape: cuDNN picks a bf16 conv's engine from its
input's shape, and engines of another K-tile sum each output in another
order (on an H100, the flagship's 192-channel 3x3 convs switch between
64x64x64 and 128x64x32 tiles as the height changes at a given width below
2^14 pixels: ``chip_profile.py --tiled-engines``). A tile's conv then
rounds one output in ~5,000 to another bf16 ulp than the whole image's,
and later layers spread it: on seed-initialised weights to 0.23 at the
output. So :func:`make_tiled_gs` runs a layer of g_s whole while a tile's
input to it would hold fewer than ``TILE_MIN_PIXELS`` pixels (those convs
see the whole image's shapes, so its bits), and tiles the layers after it;
above 2^14 pixels the engines measured keep their K-tile as the height
changes. The kernel route's bf16 conv sums in an order that depends on
neither the tile nor its position. ``g_s_tiled`` over the whole transform
tiles every layer, as the JAX package does. Pixels can still differ where
cuDNN's engines for the tile's and the whole image's shapes differ (the
fused 1536-channel subpel convs change family at 2^21 pixels); fine for
final pixels, never for the rows chain, whose bits the coder needs.

Each run goes through the codec's own transform call
(``_FastCodec._transform``, i.e. ``layers.run_transform``): canonical
strides under the pinned library settings, on the codec's route
(``kernel_transforms=True`` launches the bf16 conv kernel). Between the
whole layers and the tiles the activation passes through float32, which
holds a bf16 value exactly. There is no compile step: the module runs
eagerly on each tile.
"""

import torch

from flashgmm_tpu_torch.layers import LeakyReLU, Sequential

HALO = 8
# a layer runs tiled only where a tile's input to it holds at least this
# many pixels (module docstring)
TILE_MIN_PIXELS = 1 << 14


def g_s_tiled(transform, y_hat, tile_h: int = 32, halo: int = HALO,
              upsample: int = 16):
    """Apply a synthesis transform over H-tiles of the latent.

    Args:
        transform: callable [B, h, w, C] -> [B, h*upsample, w*upsample, 3].
        y_hat: [B, H, W, C] latent.
        tile_h: core tile height in latent rows.
        halo: overlap rows on each side (>= g_s receptive field).
        upsample: spatial scale factor of the transform (16 for the
            flagship, models/ckbd_gmm.py g_s).

    Returns [B, H*upsample, W*upsample, 3], equal to ``transform(y_hat)``
    up to float roundings.
    """
    b, h, w, c = y_hat.shape
    if h <= tile_h + 2 * halo:
        return transform(y_hat)
    n_tiles = -(-h // tile_h)
    outs = []
    for t in range(n_tiles):
        y0 = t * tile_h
        y1 = min(h, y0 + tile_h)
        top = max(0, y0 - halo)
        bot = min(h, y1 + halo)
        xt = transform(y_hat[:, top:bot])
        outs.append(xt[:, (y0 - top) * upsample:(y1 - top) * upsample])
    return torch.cat(outs, dim=1)


def make_tiled_gs(codec, tile_h: int = 32, halo: int = HALO,
                  upsample: int = 16):
    """A tiled g_s on a fast codec's transform settings (its type, route
    and snapshot of g_s), output clamped to [0, 1]. The leading layers of
    a Sequential g_s run whole while a tile's input to them would hold
    fewer than ``TILE_MIN_PIXELS`` pixels; the rest run tile by tile, the
    tiles and the halo scaled to their resolution.
    Usage:

        gs = make_tiled_gs(codec)
        x_hat = gs(codec.decode_y_hat(streams, y_shape))
    """
    g_s = codec._g_s
    layers = list(g_s.layers) if isinstance(g_s, Sequential) else [g_s]

    def run(y_hat):
        h, w = y_hat.shape[1:3]
        if h <= tile_h + 2 * halo:
            return torch.clamp(codec._transform(g_s, y_hat), 0.0, 1.0)
        x, scale, i = y_hat, 1, 0
        while (i < len(layers)
               and (tile_h + 2 * halo) * w * scale * scale
               < TILE_MIN_PIXELS):
            j = i + 1  # never part a conv from the activation it fuses
            while j < len(layers) and isinstance(layers[j], LeakyReLU):
                j += 1
            x = codec._transform(Sequential(*layers[i:j]), x)
            scale, i = x.shape[1] // h, j
        if i == len(layers):
            return torch.clamp(x, 0.0, 1.0)
        rest = Sequential(*layers[i:])
        return g_s_tiled(
            lambda xt: torch.clamp(codec._transform(rest, xt), 0.0, 1.0), x,
            tile_h=tile_h * scale, halo=halo * scale,
            upsample=upsample // scale)

    return run
