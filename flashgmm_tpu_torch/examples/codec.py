"""File-format codec CLI: encode images and videos to self-contained files
(port of the repository's examples/codec.py; the reference's
examples/codec.py).

Images: the "FGMT" container, the header ``<BBHH`` (architecture index,
quality, height, width), the tagged stream tree of ``["SHAPE", shape]`` and
of the model's strings, then ``abs_max`` where the model gives one: the
JAX package's bytes, so a file written by either package decodes in the
other when the models agree. The image is padded to a multiple of 64 by
edge replication and coded by the model's reference format
(``model.compress`` / ``decompress``). Video (ssf2020): the "FGMV"
container, ``<BHHIB`` (quality, height, width, frames, GOP), then per GOP
the shapes and strings of a keyframe and its inter frames; frames padded
to a multiple of 128; decoded frames written one file each
(``frame_00000.png``, or ``--ext ppm``).

The model runs on ``--device`` (default ``cuda``; ``cpu`` on request).
``.ppm`` images (and a directory of ``.ppm`` frames) are read and written
with numpy, so coding them needs no Pillow.

Usage:
    python -m flashgmm_tpu_torch.examples.codec encode input.ppm -o out.fgm \\
        -a cheng2020-anchor-checkerboard-gmm -q 5 --weights w.npz
    python -m flashgmm_tpu_torch.examples.codec decode out.fgm -o rec.ppm \\
        --weights w.npz
    python -m flashgmm_tpu_torch.examples.codec encode_video frames_dir/ \\
        -o out.fgmv --weights ssf.npz --gop 8
    python -m flashgmm_tpu_torch.examples.codec decode_video out.fgmv \\
        -o rec_dir/ --weights ssf.npz
"""

import argparse
import struct
import sys
from pathlib import Path

import numpy as np
import torch

MAGIC = b"FGMT"
MAGIC_V = b"FGMV"
ARCHS = [
    "bmshj2018-factorized",
    "bmshj2018-hyperprior",
    "mbt2018-mean",
    "mbt2018",
    "cheng2020-anchor",
    "cheng2020-anchor-checkerboard",
    "cheng2020-anchor-checkerboard-gmm",
    "elic2022-official",
]


def _write_stream(f, s):
    """Recursively serialize the strings structure."""
    if isinstance(s, bytes):
        f.write(struct.pack("<BI", 0, len(s)))
        f.write(s)
    elif isinstance(s, (int, np.integer)):
        f.write(struct.pack("<Bi", 1, int(s)))
    elif isinstance(s, (list, tuple)):
        f.write(struct.pack("<BI", 2, len(s)))
        for e in s:
            _write_stream(f, e)
    elif isinstance(s, str):
        b = s.encode()
        f.write(struct.pack("<BI", 4, len(b)))
        f.write(b)
    elif isinstance(s, (torch.Tensor, np.ndarray)):  # e.g. zero_bitmap
        arr = (s.cpu().numpy() if isinstance(s, torch.Tensor)
               else s).astype(np.int32)
        f.write(struct.pack("<BI", 3, arr.size))
        f.write(arr.tobytes())
    elif isinstance(s, dict):  # ssf2020 inter frames: {"motion": ..., ...}
        items = sorted(s.items())
        f.write(struct.pack("<BI", 5, len(items)))
        for k, v in items:
            _write_stream(f, k)
            _write_stream(f, v)
    else:
        raise TypeError(type(s))


def _read_stream(f):
    tag = struct.unpack("<B", f.read(1))[0]
    if tag == 0:
        (n,) = struct.unpack("<I", f.read(4))
        return f.read(n)
    if tag == 1:
        return struct.unpack("<i", f.read(4))[0]
    if tag == 2:
        (n,) = struct.unpack("<I", f.read(4))
        return tuple(_read_stream(f) for _ in range(n))
    if tag == 3:
        (n,) = struct.unpack("<I", f.read(4))
        return torch.from_numpy(np.frombuffer(f.read(n * 4), np.int32).copy())
    if tag == 4:
        (n,) = struct.unpack("<I", f.read(4))
        return f.read(n).decode()
    if tag == 5:
        (n,) = struct.unpack("<I", f.read(4))
        return {_read_stream(f): _read_stream(f) for _ in range(n)}
    raise ValueError(tag)


def _listify(s):
    """Deep tuple->list (the models' decompress APIs take lists)."""
    if isinstance(s, (list, tuple)):
        return [_listify(e) for e in s]
    if isinstance(s, dict):
        return {k: _listify(v) for k, v in s.items()}
    return s


def _shape_to_list(shape):
    if isinstance(shape, dict):
        return ["D"] + [x for k, v in sorted(shape.items())
                        for x in (k, _shape_to_list(v))]
    if isinstance(shape, (list, tuple)):
        return ["L"] + [_shape_to_list(s) for s in shape]
    return int(shape)


def _shape_from_list(lst):
    if isinstance(lst, (int, np.integer)):
        return int(lst)
    lst = list(lst)
    tag = lst[0]
    if tag == "D":
        rest = lst[1:]
        return {rest[i]: _shape_from_list(rest[i + 1])
                for i in range(0, len(rest), 2)}
    if tag == "L":
        return tuple(_shape_from_list(s) for s in lst[1:])
    raise ValueError(lst)


def setup_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("encode")
    e.add_argument("input")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("-a", "--architecture",
                   default="cheng2020-anchor-checkerboard-gmm", choices=ARCHS)
    e.add_argument("-q", "--quality", type=int, default=1)
    e.add_argument("--weights", type=str)

    d = sub.add_parser("decode")
    d.add_argument("input")
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--weights", type=str)

    ev = sub.add_parser("encode_video")
    ev.add_argument("input", help=".yuv raw video or a directory of frames")
    ev.add_argument("-o", "--output", required=True)
    ev.add_argument("-q", "--quality", type=int, default=5)
    ev.add_argument("--weights", type=str)
    ev.add_argument("--frames", type=int, default=0, help="0 = all")
    ev.add_argument("--gop", type=int, default=8)

    dv = sub.add_parser("decode_video")
    dv.add_argument("input")
    dv.add_argument("-o", "--output", required=True,
                    help="output directory for the decoded frames")
    dv.add_argument("--weights", type=str)
    dv.add_argument("--ext", default="png", choices=["png", "ppm"],
                    help="decoded frames' file type (ppm needs no Pillow)")
    for sp in (e, d, ev, dv):
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on "
                             "(default: cuda)")
    return p.parse_args(argv)


def load_model(architecture, quality, weights, device):
    """The zoo model of an image file on ``device``, its tables built
    (``update(force=False)``, as the JAX CLI)."""
    from flashgmm_tpu_torch.zoo import create_model

    model = create_model(architecture, quality, weights_path=weights,
                         device=device).eval()
    model.update(force=False)
    return model


def read_file(path):
    """An image file's fields: {"architecture", "quality", "h", "w",
    "shape", "strings", "kwargs"} (``kwargs``: ``abs_max`` where the file
    has it)."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a FGMT file")
        arch_id, quality, h, w = struct.unpack("<BBHH", f.read(6))
        shape_lst = _read_stream(f)
        if shape_lst[0] != "SHAPE":
            raise ValueError(f"{path}: no SHAPE record")
        shape = _shape_from_list(shape_lst[1])
        strings = _listify(_read_stream(f))
        extra = f.read(4)
    kwargs = {}
    if len(extra) == 4:
        kwargs["abs_max"] = struct.unpack("<i", extra)[0]
    return {"architecture": ARCHS[arch_id], "quality": quality, "h": h,
            "w": w, "shape": shape, "strings": strings, "kwargs": kwargs}


def encode(args):
    from flashgmm_tpu_torch.datasets.image import load_image
    from flashgmm_tpu_torch.ops import compute_padding, pad_image

    model = load_model(args.architecture, args.quality, args.weights,
                       args.device)
    x = torch.from_numpy(load_image(args.input))[None].to(args.device)
    h, w = x.shape[1:3]
    pad, _ = compute_padding(h, w, min_div=64)
    out = model.compress(pad_image(x, pad))

    with open(args.output, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<BBHH", ARCHS.index(args.architecture),
                            args.quality, h, w))
        _write_stream(f, ["SHAPE", _shape_to_list(out["shape"])])
        _write_stream(f, list(out["strings"]))
        if "abs_max" in out:
            f.write(struct.pack("<i", out["abs_max"]))
    nbytes = Path(args.output).stat().st_size
    print(f"{args.output}: {nbytes} bytes ({nbytes * 8 / (h * w):.3f} bpp)")


def decode(args):
    from flashgmm_tpu_torch.datasets.image import save_image
    from flashgmm_tpu_torch.ops import compute_padding, unpad_image

    rec = read_file(args.input)
    model = load_model(rec["architecture"], rec["quality"], args.weights,
                       args.device)
    out = model.decompress(rec["strings"], rec["shape"], **rec["kwargs"])
    h, w = rec["h"], rec["w"]
    _, unpad = compute_padding(h, w, min_div=64)
    x_hat = unpad_image(out["x_hat"], unpad)
    save_image(args.output, x_hat[0].cpu().numpy())
    print(f"decoded {args.input} -> {args.output} ({h}x{w})")


def _load_video_frames(path, max_frames, device):
    """.yuv file (RawVideoSequence) or a directory of image frames ->
    list of [1, H, W, 3] float RGB tensors on ``device``."""
    p = Path(path)
    if p.is_dir():
        from flashgmm_tpu_torch.datasets.image import (IMG_EXTENSIONS,
                                                       load_image)

        files = sorted(f for f in p.iterdir()
                       if f.suffix.lower() in IMG_EXTENSIONS)
        if max_frames:
            files = files[:max_frames]
        frames = [torch.from_numpy(load_image(f))[None].to(device)
                  for f in files]
    else:
        from flashgmm_tpu_torch.datasets.rawvideo import RawVideoSequence
        from flashgmm_tpu_torch.utils.video.eval_model.__main__ import \
            read_frames

        n = len(RawVideoSequence(p))
        frames = read_frames(p, min(max_frames, n) if max_frames else n,
                             device)
    if not frames:
        raise SystemExit(f"no frames found in {path}")
    return frames


def load_video_model(quality, weights, device):
    """ssf2020 on ``device``, its tables built; without weights the model
    is seed-initialised and its quantiles are updated, as the JAX CLI."""
    from flashgmm_tpu_torch.zoo import create_model

    model = create_model("ssf2020", quality, weights_path=weights,
                         device=device).eval()
    model.update(force=True, update_quantiles=weights is None)
    return model


def read_video_file(f):
    """An open video file's header and GOPs: ((quality, h, w, n_frames,
    gop), [(strings, shapes) a GOP])."""
    if f.read(4) != MAGIC_V:
        raise ValueError("not a FGMV file")
    header = struct.unpack("<BHHIB", f.read(10))
    n_frames, gop = header[3], header[4]
    gops = []
    for _ in range(-(-n_frames // gop)):
        shapes_lst = _read_stream(f)
        if shapes_lst[0] != "SHAPES":
            raise ValueError("no SHAPES record")
        shapes = list(_shape_from_list(shapes_lst[1]))
        gops.append((_listify(_read_stream(f)), shapes))
    return header, gops


def encode_video(args):
    from flashgmm_tpu_torch.ops import compute_padding, pad_image

    frames = _load_video_frames(args.input, args.frames, args.device)
    h, w = frames[0].shape[1:3]
    pad, _ = compute_padding(h, w, min_div=128)
    frames = [pad_image(f, pad) for f in frames]
    model = load_video_model(args.quality, args.weights, args.device)

    with open(args.output, "wb") as f:
        f.write(MAGIC_V)
        f.write(struct.pack("<BHHIB", args.quality, h, w, len(frames),
                            args.gop))
        for g0 in range(0, len(frames), args.gop):
            strings, shapes = model.compress(frames[g0:g0 + args.gop])
            _write_stream(f, ["SHAPES", _shape_to_list(tuple(shapes))])
            _write_stream(f, list(strings))
    nbytes = Path(args.output).stat().st_size
    print(f"{args.output}: {nbytes} bytes "
          f"({nbytes * 8 / (h * w * len(frames)):.4f} bpp/frame)")


def decode_video(args):
    from flashgmm_tpu_torch.datasets.image import save_image
    from flashgmm_tpu_torch.ops import compute_padding, unpad_image

    with open(args.input, "rb") as f:
        (quality, h, w, n_frames, _), gops = read_video_file(f)
    model = load_video_model(quality, args.weights, args.device)
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    _, unpad = compute_padding(h, w, min_div=128)
    idx = 0
    for strings, shapes in gops:
        for fr in model.decompress(strings, shapes):
            fr = unpad_image(fr, unpad)
            save_image(outdir / f"frame_{idx:05d}.{args.ext}",
                       fr[0].cpu().numpy())
            idx += 1
    print(f"decoded {args.input} -> {args.output} ({idx} frames {h}x{w})")


def main(argv=None):
    args = setup_args(argv)
    {"encode": encode, "decode": decode, "encode_video": encode_video,
     "decode_video": decode_video}[args.command](args)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
