"""Synthetic natural-image-statistics content (the port's own copy of
``dead_leaves``, ``textured_leaves``, ``make_pool`` and ``random_crop`` from
flashgmm_tpu/datasets/synthetic.py; a copy, because importing anything under
flashgmm_tpu imports JAX).

Pure numpy and deterministic in the seed, so the same seed gives the same
image in both packages. ``textured_leaves`` is dead leaves + per-disk linear
gradients, global smooth illumination, mild blur and sensor noise; it codes
at 0.4-1.0 bpp under a trained model, like real photos.
"""

import numpy as np

__all__ = ["dead_leaves", "make_pool", "random_crop", "textured_leaves"]


def _disk_bbox(h, w, cy, cx, r):
    y0 = max(int(np.floor(cy - r)), 0)
    y1 = min(int(np.ceil(cy + r)) + 1, h)
    x0 = max(int(np.floor(cx - r)), 0)
    x1 = min(int(np.ceil(cx + r)) + 1, w)
    return y0, y1, x0, x1


def dead_leaves(h, w, seed=0, rmin=2.0, rmax=120.0, alpha=3.0,
                max_disks=4000, gradients=True, rng=None):
    """Render a dead-leaves image in [0,1]^3.

    Radii follow p(r) ∝ r^-alpha on [rmin, rmax] (alpha=3 gives scale
    invariance). Disks are drawn until the canvas is covered or max_disks.
    """
    rng = rng or np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    covered = np.zeros((h, w), bool)
    # inverse-CDF sampling of the truncated power law
    u = rng.rand(max_disks)
    if alpha == 1.0:
        radii = rmin * (rmax / rmin) ** u
    else:
        a = 1.0 - alpha
        radii = (rmin**a + u * (rmax**a - rmin**a)) ** (1.0 / a)
    cys = rng.rand(max_disks) * h
    cxs = rng.rand(max_disks) * w
    colors = rng.rand(max_disks, 3).astype(np.float32)
    # draw back-to-front: later disks occlude earlier ones, so iterate
    # front-to-back and only paint not-yet-covered pixels (single pass)
    n_pix = h * w
    n_cov = 0
    for i in range(max_disks):
        r = radii[i]
        y0, y1, x0, x1 = _disk_bbox(h, w, cys[i], cxs[i], r)
        if y0 >= y1 or x0 >= x1:
            continue
        yy = np.arange(y0, y1, dtype=np.float32)[:, None] - cys[i]
        xx = np.arange(x0, x1, dtype=np.float32)[None, :] - cxs[i]
        inside = (yy * yy + xx * xx) <= r * r
        free = inside & ~covered[y0:y1, x0:x1]
        if not free.any():
            continue
        c = colors[i]
        if gradients:
            gdir = rng.randn(2).astype(np.float32)
            gdir /= np.hypot(*gdir) + 1e-6
            ramp = (yy * gdir[0] + xx * gdir[1]) / (2 * r)
            shade = 1.0 + 0.35 * ramp
            patch = np.clip(c[None, None, :] * shade[:, :, None], 0, 1)
            img[y0:y1, x0:x1][free] = patch[free]
        else:
            img[y0:y1, x0:x1][free] = c
        covered[y0:y1, x0:x1] |= inside
        n_new = int(free.sum())
        n_cov += n_new
        if n_cov >= n_pix:
            break
    if n_cov < n_pix:
        img[~covered] = rng.rand(3).astype(np.float32)
    return img


def _blur3(img, strength=1.0):
    """Separable 3-tap blur (anti-alias / optics)."""
    k = np.array([strength, 2.0, strength], np.float32)
    k /= k.sum()
    out = img
    out = (
        np.pad(out, ((1, 1), (0, 0), (0, 0)), "edge")[:-2] * k[0]
        + out * k[1]
        + np.pad(out, ((1, 1), (0, 0), (0, 0)), "edge")[2:] * k[2]
    )
    out = (
        np.pad(out, ((0, 0), (1, 1), (0, 0)), "edge")[:, :-2] * k[0]
        + out * k[1]
        + np.pad(out, ((0, 0), (1, 1), (0, 0)), "edge")[:, 2:] * k[2]
    )
    return out


def textured_leaves(h, w, seed=0, noise_std=0.01):
    """Dead leaves + smooth illumination + blur + sensor noise."""
    rng = np.random.RandomState(seed)
    img = dead_leaves(h, w, rng=rng)
    # global low-frequency illumination field
    gh, gw = max(h // 64, 2), max(w // 64, 2)
    field = rng.rand(gh, gw, 1).astype(np.float32)
    # bilinear upsample via np
    yi = np.linspace(0, gh - 1, h, dtype=np.float32)
    xi = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.clip(yi.astype(int), 0, gh - 2)
    x0 = np.clip(xi.astype(int), 0, gw - 2)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    f00 = field[y0][:, x0]
    f01 = field[y0][:, x0 + 1]
    f10 = field[y0 + 1][:, x0]
    f11 = field[y0 + 1][:, x0 + 1]
    illum = (1 - fy) * ((1 - fx) * f00 + fx * f01) + fy * ((1 - fx) * f10 + fx * f11)
    img = img * (0.75 + 0.5 * illum)
    img = _blur3(img)
    img = img + rng.randn(h, w, 3).astype(np.float32) * noise_std
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def make_pool(n, h, w, seed0=0, kind="textured"):
    """Generate a pool of images (list of [h,w,3] float32)."""
    fn = textured_leaves if kind == "textured" else dead_leaves
    return [np.asarray(fn(h, w, seed=seed0 + i), np.float32) for i in range(n)]


def random_crop(pool, batch, crop, rng):
    """Sample a [batch, crop, crop, 3] training batch from a pool: each crop
    from a random image at a random place, flipped left-right with
    probability 1/2, all drawn from the numpy ``RandomState`` ``rng``."""
    out = np.empty((batch, crop, crop, 3), np.float32)
    for b in range(batch):
        img = pool[rng.randint(len(pool))]
        h, w = img.shape[:2]
        y = rng.randint(h - crop + 1)
        x = rng.randint(w - crop + 1)
        patch = img[y:y + crop, x:x + crop]
        if rng.rand() < 0.5:
            patch = patch[:, ::-1]
        out[b] = patch
    return out
