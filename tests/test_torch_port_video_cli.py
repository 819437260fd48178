"""The port's video evaluation CLI and raw-video reader against the JAX
package's, on the CPU.

- ``RawVideoSequence``: the same file-name parse and the same planes (and
  their float32 values) as JAX's, for 8-bit 4:2:0 and 10-bit 4:4:4 files.
- ``python -m flashgmm_tpu_torch.utils.video.eval_model``: both CLIs'
  ``main(argv)`` with ``--real`` over one seeded 128x128 3-frame 8-bit
  4:2:0 ``.yuv`` (a textured-leaves still panned by integer offsets), on
  the shipped weights weights/ssf2020_synthetic.npz: JAX's ``-p`` takes the
  orbax checkpoint that JAX's ``utils/checkpoint`` writes of its
  npz-loaded model, the port's the port checkpoint of its own (``--device
  cpu``). The reports agree within 1 % in bpp, 0.05 dB in PSNR (RGB and
  YUV) and 1e-3 in MS-SSIM (the image CLI's bounds,
  test_torch_port_eval_cli.py).

JAX builds each of its GaussianConditionals' tables in seconds, and every
one of ssf2020's three has the default scale table, so inside JAX's CLI
the first table set is built and the other two take a copy (the same
arrays).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from flashgmm_tpu.datasets import rawvideo as j_rawvideo
from flashgmm_tpu.entropy_models import GaussianConditional as JGC
from flashgmm_tpu.utils.checkpoint import save_checkpoint as j_save
from flashgmm_tpu.utils.video.eval_model.__main__ import main as j_main
from flashgmm_tpu.zoo import image_models as j_image_models
from flashgmm_tpu_torch.datasets import rawvideo, textured_leaves
from flashgmm_tpu_torch.utils.checkpoint import save_checkpoint
from flashgmm_tpu_torch.utils.video.eval_model.__main__ import main as t_main
from flashgmm_tpu_torch.zoo import image_models

torch.set_num_threads(2)

SIDE, N_FRAMES = 128, 3


def _yuv420_frames(side=SIDE, n=N_FRAMES, seed=500002):
    """n 8-bit 4:2:0 frames (BT.601 full range) of a panned still."""
    big = textured_leaves(side + 16, side + 16, seed=seed).astype(np.float64)
    out = []
    for i in range(n):
        r, g, b = np.moveaxis(big[2 * i:2 * i + side, i:i + side], -1, 0)
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = 0.5 * (b - y) / (1 - 0.114) + 0.5
        v = 0.5 * (r - y) / (1 - 0.299) + 0.5
        planes = [y] + [c.reshape(side // 2, 2, side // 2, 2).mean((1, 3))
                        for c in (u, v)]
        out.append(b"".join(np.clip(np.round(p * 255), 0, 255).astype(
            np.uint8).tobytes() for p in planes))
    return b"".join(out)


@pytest.mark.parametrize("name,dtype,chroma", [
    ("BasketballDrill_64x32_50_420_8bit.yuv", np.uint8, (16, 32)),
    ("seq-64x32-25fps-yuv444-10bit.yuv", np.uint16, (32, 64))])
def test_raw_video_sequence_reads_jax_planes(tmp_path, name, dtype, chroma):
    n_px = 64 * 32 + 2 * chroma[0] * chroma[1]
    rng = np.random.RandomState(0)
    hi = 256 if dtype == np.uint8 else 1024
    path = tmp_path / name
    rng.randint(0, hi, 3 * n_px).astype(dtype).tofile(path)
    info, ref_info = (rawvideo.get_raw_video_file_info(name),
                      j_rawvideo.get_raw_video_file_info(name))
    assert {k: getattr(v, "value", v) for k, v in info.items()} == {
        k: getattr(v, "value", v) for k, v in ref_info.items()}
    ours, ref = rawvideo.RawVideoSequence(path), j_rawvideo.RawVideoSequence(
        path)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        planes, want = ours[i], ref[i]
        assert planes[1].shape == chroma
        for got, w in zip(planes, want):
            assert got.dtype == dtype and np.array_equal(got, w)
        for got, w in zip(ours.to_float(planes), ref.to_float(want)):
            assert got.dtype == np.float32 and np.array_equal(got, w)


@pytest.fixture
def one_jax_table_set(monkeypatch):
    """JAX's GaussianConditionals take the first one's tables (module
    docstring)."""
    update = JGC.update_scale_table
    names = ("scale_table", "_quantized_cdf", "_offset", "_cdf_length")
    cache = {}

    def once(self, scale_table, force=False):
        key = tuple(float(s) for s in scale_table)
        if key not in cache:
            updated = update(self, scale_table, force=force)
            cache[key] = {n: getattr(self, n).value for n in names}
            return updated
        for n in names:
            getattr(self, n).value = cache[key][n]
        return True

    monkeypatch.setattr(JGC, "update_scale_table", once)


def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


def test_eval_cli_reports_agree_with_jax(tmp_path, one_jax_table_set):
    seq = tmp_path / f"leaves_{SIDE}x{SIDE}_30fps_420_8bit.yuv"
    seq.write_bytes(_yuv420_frames())
    j_save(tmp_path / "jax_ckpt", j_image_models("ssf2020", 5,
                                                 pretrained=True))
    save_checkpoint(tmp_path / "port_ckpt", image_models(
        "ssf2020", 5, pretrained=True, device="cpu"))
    argv = [str(seq), "-f", str(N_FRAMES), "--gop", str(N_FRAMES), "--real"]
    ref = _report(j_main, argv + ["-p", str(tmp_path / "jax_ckpt")])
    got = _report(t_main, argv + ["-p", str(tmp_path / "port_ckpt"),
                                  "--device", "cpu"])
    assert got["name"] == ref["name"] == "ssf2020"
    assert got["description"] == ref["description"]
    assert set(got["results"]) == set(ref["results"])
    print("JAX: " + json.dumps(ref["results"]))
    print("port: " + json.dumps(got["results"]))
    r, g = ref["results"], got["results"]
    np.testing.assert_allclose(g["bpp"], r["bpp"], rtol=1e-2)
    assert abs(g["psnr-rgb"] - r["psnr-rgb"]) <= 0.05
    assert abs(g["psnr-yuv"] - r["psnr-yuv"]) <= 0.05
    assert abs(g["ms-ssim-rgb"] - r["ms-ssim-rgb"]) <= 1e-3
    assert g["enc_time_per_frame"] > 0 and g["dec_time_per_frame"] > 0
