"""Find the codec quality achieving a target metric value by bisection
(port of flashgmm_tpu/utils/find_close/__main__.py; ``python -m
compressai.utils.find_close``, utils/find_close/__main__.py:29-146, for
classical codecs), on the host.

Usage: python -m flashgmm_tpu_torch.utils.find_close jpeg image.png 30 \
    -m psnr-rgb
"""

import argparse
import sys

# Metrics whose value DECREASES as codec quality increases (none today).
_DECREASING_METRICS = frozenset()


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("codec", choices=["jpeg", "webp", "jpeg2000"])
    p.add_argument("image", type=str)
    p.add_argument("target", type=float)
    p.add_argument("-m", "--metric", default="psnr-rgb",
                   choices=["bpp", "psnr-rgb", "ms-ssim-rgb"])
    p.add_argument("-s", "--save", type=str, help="save closest output")
    return p.parse_args(argv)


def main(argv=None):
    args = setup_args(argv)

    from flashgmm_tpu_torch.utils.bench.codecs import get_codec

    codec = get_codec(args.codec)
    lo, hi = codec.quality_range
    best = None
    # integer-quality bisection on the (monotone) quality-metric curve
    while hi - lo > 1:
        mid = (lo + hi) // 2
        rv = codec.run(args.image, mid)
        val = rv[args.metric]
        if best is None or abs(val - args.target) < abs(best[1] - args.target):
            best = (mid, val, rv)
        # Direction of the quality-metric curve.  Every currently supported
        # metric (bpp, psnr-rgb, ms-ssim-rgb) increases with codec quality;
        # list any future decreasing metric here so the bisection flips.
        increasing = args.metric not in _DECREASING_METRICS
        if (val < args.target) == increasing:
            lo = mid
        else:
            hi = mid

    q, val, rv = best
    print(f"quality={q} {args.metric}={val:.4f} "
          f"(bpp={rv['bpp']:.4f}, psnr={rv['psnr-rgb']:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
