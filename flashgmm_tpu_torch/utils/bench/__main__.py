"""Benchmark classical codecs over an image directory (port of
flashgmm_tpu/utils/bench/__main__.py; the reference's
utils/bench/__main__.py), ThreadPoolExecutor-parallel, on the host. Prints
one JSON report (and writes it to ``-o``).

Usage: python -m flashgmm_tpu_torch.utils.bench jpeg <dir> -q 10 20 ... 90
"""

import argparse
import json
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("codec", type=str)
    p.add_argument("dataset", type=str)
    p.add_argument("-q", "--qualities", type=int, nargs="+",
                   default=[10, 30, 50, 70, 90])
    p.add_argument("-j", "--num-jobs", type=int, default=4)
    p.add_argument("-o", "--output", type=str)
    # external-binary codec options (reference utils/bench setup_args)
    p.add_argument("--build-dir", type=str, default="",
                   help="VTM/HM/AV1 binaries directory")
    p.add_argument("--config", type=str, default="",
                   help="VTM/HM encoder config file")
    p.add_argument("--tfci-path", type=str, default="tfci.py")
    p.add_argument("--tfci-model", type=str,
                   default="bmshj2018-factorized-mse")
    return p.parse_args(argv)


def main(argv=None):
    args = setup_args(argv)

    from flashgmm_tpu_torch.datasets.image import IMG_EXTENSIONS
    from flashgmm_tpu_torch.utils.bench.codecs import get_codec

    kwargs = {}
    if args.codec in ("vtm", "hm"):
        kwargs = {"build_dir": args.build_dir, "config": args.config}
    elif args.codec == "av1":
        kwargs = {"build_dir": args.build_dir}
    elif args.codec == "tfci":
        kwargs = {"tfci_path": args.tfci_path, "model": args.tfci_model}
    codec = get_codec(args.codec, **kwargs)
    images = sorted(
        f for f in Path(args.dataset).iterdir()
        if f.suffix.lower() in IMG_EXTENSIONS
    )
    if not images:
        raise SystemExit(f"No images in {args.dataset}")

    per_quality = {}
    for q in args.qualities:
        agg = defaultdict(list)
        with ThreadPoolExecutor(max_workers=args.num_jobs) as ex:
            for rv in ex.map(lambda f: codec.run(f, q), images):
                for k, v in rv.items():
                    agg[k].append(v)
        per_quality[q] = {k: float(np.mean(v)) for k, v in agg.items()}

    results = defaultdict(list)
    for q in args.qualities:
        for k, v in per_quality[q].items():
            results[k].append(v)

    output = {
        "name": codec.name,
        "description": f"{codec.name} benchmark",
        "results": dict(results),
    }
    print(json.dumps(output, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(output, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
