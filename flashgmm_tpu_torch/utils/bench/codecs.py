"""Classical-codec wrappers for benchmarking (port of
flashgmm_tpu/utils/bench/codecs.py; the reference's
utils/bench/codecs.py:145-909).

PIL-backed JPEG/WebP/JPEG2000 (Pillow imported when a codec runs); external
binaries (BPG/VTM/HM/AV1/TFCI) wrapped behind availability checks: a codec
whose binary is missing raises a clear error. PSNR and MS-SSIM come from
the port's ``utils/metrics.py``, on the host (CPU tensors).
"""

import io
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch


class Codec:
    name = "codec"
    quality_range = (1, 100)

    def run(self, image_path, quality):
        raise NotImplementedError


class _PillowCodec(Codec):
    fmt = None
    ext = None

    def run(self, image_path, quality):
        from PIL import Image

        img = Image.open(image_path).convert("RGB")
        start = time.time()
        buf = io.BytesIO()
        img.save(buf, format=self.fmt, quality=quality)
        enc_time = time.time() - start
        nbytes = buf.tell()

        start = time.time()
        buf.seek(0)
        rec = Image.open(buf).convert("RGB")
        dec_time = time.time() - start
        return _metrics(np.asarray(img, np.float32) / 255.0,
                        np.asarray(rec, np.float32) / 255.0, nbytes,
                        enc_time, dec_time)


class JPEG(_PillowCodec):
    name = "jpeg"
    fmt = "JPEG"
    quality_range = (1, 96)


class WebP(_PillowCodec):
    name = "webp"
    fmt = "WEBP"
    quality_range = (1, 100)


class JPEG2000(Codec):
    name = "jpeg2000"
    quality_range = (1, 200)  # compression ratio

    def run(self, image_path, quality):
        from PIL import Image

        img = Image.open(image_path).convert("RGB")
        buf = io.BytesIO()
        start = time.time()
        img.save(buf, format="JPEG2000", quality_mode="rates",
                 quality_layers=[quality])
        enc_time = time.time() - start
        nbytes = buf.tell()
        start = time.time()
        buf.seek(0)
        rec = Image.open(buf).convert("RGB")
        dec_time = time.time() - start
        return _metrics(np.asarray(img, np.float32) / 255.0,
                        np.asarray(rec, np.float32) / 255.0, nbytes,
                        enc_time, dec_time)


# ---------------------------------------------------------------------------
# External-binary codec pipelines (reference utils/bench/codecs.py:145-909):
# full subprocess encode/decode flows with timing and RGB metrics. The
# binaries are not shipped; each codec checks availability and raises a
# clear error, and the commands are unit-tested
# (tests/test_torch_port_tools_cli.py).
# ---------------------------------------------------------------------------


def _rgb2ycbcr_planar(arr):
    """uint8 HWC RGB -> uint8 CHW YCbCr (BT.601 full-range float math)."""
    x = arr.astype(np.float32) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 + (b - y) * 0.564
    cr = 0.5 + (r - y) * 0.713
    out = np.stack([y, cb, cr])
    return (out.clip(0, 1) * 255.0 + 0.5).astype(np.uint8)


def _ycbcr2rgb_planar(arr):
    """uint8 CHW YCbCr -> float32 HWC RGB in [0,1]."""
    x = arr.astype(np.float32) / 255.0
    y, cb, cr = x[0], x[1], x[2]
    r = y + 1.403 * (cr - 0.5)
    g = y - 0.714 * (cr - 0.5) - 0.344 * (cb - 0.5)
    b = y + 1.773 * (cb - 0.5)
    return np.stack([r, g, b], axis=-1).clip(0, 1)


def _metrics(orig_rgb01, rec_rgb01, nbytes, enc_time, dec_time):
    """The report of one coded image: bpp, RGB PSNR and MS-SSIM (the port's
    metrics on [1, H, W, 3] float32 CPU tensors) and the seconds."""
    from flashgmm_tpu_torch.utils.metrics import ms_ssim as _ms
    from flashgmm_tpu_torch.utils.metrics import psnr as _psnr

    a = torch.from_numpy(np.ascontiguousarray(orig_rgb01, np.float32))[None]
    b = torch.from_numpy(np.ascontiguousarray(rec_rgb01, np.float32))[None]
    h, w = orig_rgb01.shape[:2]
    return {
        "bpp": nbytes * 8.0 / (h * w),
        "psnr-rgb": float(_psnr(a, b)),
        "ms-ssim-rgb": float(_ms(a, b)),
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


def _run(cmd):
    subprocess.run(
        [str(c) for c in cmd], check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )


class _BinaryCodec(Codec):
    """Subprocess codec: bitstream-file encode + decode with timing."""

    binary = None  # availability probe

    def _check(self):
        path = self.binary
        if shutil.which(path) is None and not os.path.isfile(path):
            raise RuntimeError(
                f"{self.name} requires the '{path}' binary "
                "(not available in this environment)"
            )


class BPG(_BinaryCodec):
    """BPG (Bellard HEVC still-image): bpgenc/bpgdec
    (reference codecs.py:344-438)."""

    name = "bpg"
    quality_range = (0, 51)

    def __init__(self, color_mode="ycbcr", encoder="x265",
                 subsampling_mode="444", bitdepth="8",
                 encoder_path="bpgenc", decoder_path="bpgdec"):
        self.color_mode = color_mode
        self.encoder = encoder
        self.subsampling_mode = subsampling_mode
        self.bitdepth = bitdepth
        self.encoder_path = encoder_path
        self.decoder_path = decoder_path
        self.binary = encoder_path

    def encode_cmd(self, in_path, quality, out_path):
        if not 0 <= int(quality) <= 51:
            raise ValueError(f"Invalid quality value: {quality} (0,51)")
        return [
            self.encoder_path, "-o", out_path, "-q", str(quality),
            "-f", self.subsampling_mode, "-e", self.encoder,
            "-c", self.color_mode, "-b", self.bitdepth, in_path,
        ]

    def decode_cmd(self, out_path, rec_path):
        return [self.decoder_path, "-o", rec_path, out_path]

    def run(self, image_path, quality):
        from PIL import Image

        self._check()
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "out.bpg")
            rec_path = os.path.join(tmp, "rec.png")
            start = time.time()
            _run(self.encode_cmd(str(image_path), quality, out_path))
            enc_time = time.time() - start
            start = time.time()
            _run(self.decode_cmd(out_path, rec_path))
            dec_time = time.time() - start
            nbytes = os.path.getsize(out_path)
            orig = np.asarray(
                Image.open(image_path).convert("RGB"), np.float32
            ) / 255.0
            rec = np.asarray(
                Image.open(rec_path).convert("RGB"), np.float32
            ) / 255.0
        return _metrics(orig, rec, nbytes, enc_time, dec_time)


class _Yuv444Codec(_BinaryCodec):
    """Shared raw-YUV444 pipeline: RGB -> planar YCbCr444 .yuv -> encoder ->
    bitstream -> decoder -> .yuv -> RGB metrics (the VTM/HM/AV1 flow,
    reference codecs.py:503-909)."""

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        raise NotImplementedError

    def decode_cmd(self, out_path, yuv_path):
        raise NotImplementedError

    def run(self, image_path, quality):
        from PIL import Image

        self._check()
        img = np.asarray(Image.open(image_path).convert("RGB"))
        arr = _rgb2ycbcr_planar(img)  # [3, H, W] uint8
        _, height, width = arr.shape
        with tempfile.TemporaryDirectory() as tmp:
            yuv_path = os.path.join(tmp, "in.yuv")
            out_path = os.path.join(tmp, "out.bin")
            rec_yuv = os.path.join(tmp, "rec.yuv")
            with open(yuv_path, "wb") as f:
                f.write(arr.tobytes())
            start = time.time()
            _run(self.encode_cmd(yuv_path, quality, out_path, width, height))
            enc_time = time.time() - start
            start = time.time()
            _run(self.decode_cmd(out_path, rec_yuv))
            dec_time = time.time() - start
            nbytes = os.path.getsize(out_path)
            rec_arr = np.fromfile(rec_yuv, dtype=np.uint8).reshape(arr.shape)
        orig = img.astype(np.float32) / 255.0
        rec = _ycbcr2rgb_planar(rec_arr)
        return _metrics(orig, rec, nbytes, enc_time, dec_time)


class VTM(_Yuv444Codec):
    """VTM (VVC reference software) all-intra still coding
    (reference codecs.py:503-637)."""

    name = "vtm"
    quality_range = (0, 63)

    def __init__(self, build_dir="", config=""):
        self.encoder_path = os.path.join(build_dir, "EncoderAppStatic")
        self.decoder_path = os.path.join(build_dir, "DecoderAppStatic")
        self.config_path = config
        self.binary = self.encoder_path

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        if not 0 <= int(quality) <= 63:
            raise ValueError(f"Invalid quality value: {quality} (0,63)")
        return [
            self.encoder_path, "-i", yuv_path, "-c", self.config_path,
            "-q", quality, "-o", "/dev/null", "-b", out_path,
            "-wdt", width, "-hgt", height, "-fr", "1", "-f", "1",
            "--InputChromaFormat=444", "--InputBitDepth=8",
            "--ConformanceWindowMode=1",
        ]

    def decode_cmd(self, out_path, yuv_path):
        return [self.decoder_path, "-b", out_path, "-o", yuv_path, "-d", 8]


class HM(_Yuv444Codec):
    """HM (HEVC reference software) all-intra still coding
    (reference codecs.py:639-757)."""

    name = "hm"
    quality_range = (0, 51)

    def __init__(self, build_dir="", config=""):
        self.encoder_path = os.path.join(build_dir, "TAppEncoderStatic")
        self.decoder_path = os.path.join(build_dir, "TAppDecoderStatic")
        self.config_path = config
        self.binary = self.encoder_path

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        if not 0 <= int(quality) <= 51:
            raise ValueError(f"Invalid quality value: {quality} (0,51)")
        return [
            self.encoder_path, "-i", yuv_path, "-c", self.config_path,
            "-q", quality, "-o", "/dev/null", "-b", out_path,
            "-wdt", width, "-hgt", height, "-fr", "1", "-f", "1",
            "--InputChromaFormat=444", "--InputBitDepth=8", "--SEIDecodedPictureHash",
        ]

    def decode_cmd(self, out_path, yuv_path):
        return [self.decoder_path, "-b", out_path, "-o", yuv_path, "-d", 8]


class AV1(_Yuv444Codec):
    """AV1 (libaom) still coding (reference codecs.py:784-909)."""

    name = "av1"
    quality_range = (0, 63)

    def __init__(self, build_dir=""):
        self.encoder_path = os.path.join(build_dir, "aomenc")
        self.decoder_path = os.path.join(build_dir, "aomdec")
        self.binary = self.encoder_path

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        if not 0 <= int(quality) <= 63:
            raise ValueError(f"Invalid quality value: {quality} (0,63)")
        return [
            self.encoder_path, "-w", width, "-h", height,
            "--fps=1/1", "--limit=1", "--input-bit-depth=8",
            "--cpu-used=0", "--threads=1", "--passes=2", "--end-usage=q",
            f"--cq-level={quality}", "--i444", "--skip=0", "--tune=psnr",
            "--psnr", "--bit-depth=8", "-o", out_path, yuv_path,
        ]

    def decode_cmd(self, out_path, yuv_path):
        return [
            self.decoder_path, out_path, "-o", yuv_path,
            "--rawvideo", "--output-bit-depth=8",
        ]


class TFCI(_BinaryCodec):
    """TensorFlow-Compression models via the tfci.py script
    (reference codecs.py:440-501)."""

    name = "tfci"
    quality_range = (1, 8)
    models = ("bmshj2018-factorized-mse", "bmshj2018-hyperprior-mse",
              "mbt2018-mean-mse")

    def __init__(self, tfci_path="tfci.py", model="bmshj2018-factorized-mse"):
        self.tfci_path = tfci_path
        self.model = model
        self.binary = tfci_path

    def encode_cmd(self, in_path, quality, out_path):
        if not 1 <= int(quality) <= 8:
            raise ValueError(f"Invalid quality value: {quality} (1,8)")
        import sys as _sys

        return [_sys.executable, self.tfci_path, "compress",
                f"{self.model}-{int(quality)}", in_path, out_path]

    def decode_cmd(self, out_path, rec_path):
        import sys as _sys

        return [_sys.executable, self.tfci_path, "decompress", out_path,
                rec_path]

    def run(self, image_path, quality):
        from PIL import Image

        self._check()
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "out.tfci")
            rec_path = os.path.join(tmp, "rec.png")
            start = time.time()
            _run(self.encode_cmd(str(image_path), quality, out_path))
            enc_time = time.time() - start
            start = time.time()
            _run(self.decode_cmd(out_path, rec_path))
            dec_time = time.time() - start
            nbytes = os.path.getsize(out_path)
            orig = np.asarray(
                Image.open(image_path).convert("RGB"), np.float32
            ) / 255.0
            rec = np.asarray(
                Image.open(rec_path).convert("RGB"), np.float32
            ) / 255.0
        return _metrics(orig, rec, nbytes, enc_time, dec_time)


_CODECS = {c.name: c for c in (JPEG, WebP, JPEG2000, BPG, VTM, HM, AV1, TFCI)}


def get_codec(name: str, **kwargs) -> Codec:
    return _CODECS[name](**kwargs)
