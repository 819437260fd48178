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
is < 7 latent rows per side; HALO=8 is safe. Pixels can still differ from
the untiled transform by float roundings where a library conv picks
another algorithm for the tile's shape; the bf16 conv kernel's reduction
order depends on neither the tile nor its position. Fine for final pixels;
never use it on the rows chain, whose bits the coder needs.

Each tile goes through the codec's own transform call
(``_FastCodec._transform``, i.e. ``layers.run_transform``): canonical
strides under the pinned library settings, on the codec's route
(``kernel_transforms=True`` launches the bf16 conv kernel). There is no
compile step: the module runs eagerly on each tile.
"""

import torch

HALO = 8


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
    and snapshot of g_s), output clamped to [0, 1]. Usage:

        gs = make_tiled_gs(codec)
        x_hat = gs(codec.decode_y_hat(streams, y_shape))
    """
    def one_tile(yt):
        return torch.clamp(codec._transform(codec._g_s, yt), 0.0, 1.0)

    def run(y_hat):
        return g_s_tiled(one_tile, y_hat, tile_h=tile_h, halo=halo,
                         upsample=upsample)

    return run
