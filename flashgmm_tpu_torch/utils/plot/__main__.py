"""Plot RD curves from eval_model (or bench) JSON result files (port of
flashgmm_tpu/utils/plot/__main__.py; ``python -m compressai.utils.plot``,
utils/plot/__main__.py): the matplotlib backend (imported when it plots);
the plotly backend is refused, as in the JAX package.

Usage: python -m flashgmm_tpu_torch.utils.plot -f a.json b.json -o rd.png
"""

import argparse
import json
import sys
from pathlib import Path


def setup_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", "--results-file", nargs="+", required=True)
    p.add_argument("-m", "--metric", default="psnr-rgb",
                   choices=["psnr-rgb", "ms-ssim-rgb"])
    p.add_argument("-t", "--title", default="Rate-distortion")
    p.add_argument("-o", "--output", type=str, help="output figure path")
    p.add_argument("--backend", default="matplotlib",
                   choices=["matplotlib", "plotly"])
    return p.parse_args(argv)


def load_results(path):
    with open(path) as f:
        data = json.load(f)
    results = data["results"]
    bpp = results["bpp"]
    if not isinstance(bpp, list):
        results = {k: [v] for k, v in results.items()}
    return data.get("name", Path(path).stem), results


def main(argv=None):
    args = setup_args(argv)

    series = [load_results(f) for f in args.results_file]

    if args.backend == "matplotlib":
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        for name, results in series:
            order = sorted(range(len(results["bpp"])),
                           key=lambda i: results["bpp"][i])
            xs = [results["bpp"][i] for i in order]
            ys = [results[args.metric][i] for i in order]
            ax.plot(xs, ys, marker="o", label=name)
        ax.set_xlabel("Bit-rate [bpp]")
        ax.set_ylabel(args.metric)
        ax.set_title(args.title)
        ax.grid(True, alpha=0.3)
        ax.legend()
        out = args.output or "rd_curves.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        print(f"Saved {out}")
    else:
        raise SystemExit("plotly backend not available in this environment")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
