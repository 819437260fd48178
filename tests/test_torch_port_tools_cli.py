"""The port's file codec CLI (``python -m flashgmm_tpu_torch.examples.
codec``), host tool CLIs (``utils.bench``, ``find_close``, ``plot``,
``video.bench``, ``video.plot``), ``utils.profiler``, the dataset wrappers,
``layers.basic`` and ``zoo.torch_export``, held against the JAX package's
(examples/codec.py, flashgmm_tpu/utils/..., flashgmm_tpu/zoo/
torch_export.py), on the CPU:

- .fgm image files of the port's CLI (``--device cpu``) decode to the
  symbols the port's encoder quantized, each architecture of the CLI's
  list but ELIC (its zoo widths, 192 and 320, take ~40 s on the CPU; the
  card codes it in the smoke's reference phase), and a 2-frame ssf2020 GOP
  decodes to the encoder's reconstructions within 1 level;
- the bmshj2018-factorized file of each package's CLI (the repository's
  weights) decodes in the other to the writer's symbols, exactly;
- bench, find_close and plot on the same tiny PNG: the same JPEG bytes
  (equal bpp), PSNR and MS-SSIM within ``METRIC_ATOL`` = 1e-5 of JAX's;
  the video bench's commands as tests/test_misc_components.py:192 and its
  frame metrics within 1e-5 of JAX's;
- ``PhaseTimer``, ``trace``, ``annotate``; ``CacheDataset``,
  ``StackDataset``, ``PreGeneratedMemmapDataset`` and ``layers.basic``
  equal to JAX's on the same arrays;
- ``export_torch_state_dict`` equal to JAX's export on the same weights
  (same keys, equal arrays), and ``torch_convert`` followed by
  ``torch_export`` the identity on the reference state dicts of
  tests/expected/reference/model_interop_{ckbd,elic}.npz.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from flashgmm_tpu_torch.datasets import load_image, save_image
from flashgmm_tpu_torch.examples import codec

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FACTORIZED = str(REPO / "weights" / "factorized_n128_m192_synthetic.npz")
METRIC_ATOL = 1e-5


def _jax_codec_cli():
    """The JAX package's examples/codec.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_codec", REPO / "examples" / "codec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """A 64x96 smooth image as .ppm (numpy IO) and .png (Pillow)."""
    d = tmp_path_factory.mktemp("img")
    rs = np.random.RandomState(0)
    img = np.clip(np.cumsum(rs.normal(0, .03, (64, 96, 3)), 1) + .5, 0, 1)
    save_image(d / "in.ppm", img.astype(np.float32))
    save_image(d / "in.png", img.astype(np.float32))
    return d / "in.ppm", d / "in.png"


# -- the .fgm image and video files -----------------------------------------

@pytest.mark.parametrize("arch, weights", [
    ("bmshj2018-factorized", FACTORIZED),
    ("bmshj2018-hyperprior", None), ("mbt2018-mean", None),
    ("mbt2018", None), ("cheng2020-anchor", None),
    ("cheng2020-anchor-checkerboard", None),
    ("cheng2020-anchor-checkerboard-gmm", None)])
def test_image_file_round_trip(image, tmp_path, arch, weights):
    from flashgmm_tpu_torch.ops import compute_padding, pad_image

    ppm, _ = image
    extra = ["--weights", weights] if weights else []
    fgm, rec = tmp_path / "o.fgm", tmp_path / "r.ppm"
    assert codec.main(["encode", str(ppm), "-o", str(fgm), "-a", arch,
                       "--device", "cpu", *extra]) == 0
    assert codec.main(["decode", str(fgm), "-o", str(rec), "--device", "cpu",
                       *extra]) == 0
    assert load_image(rec).shape == (64, 96, 3)

    f = codec.read_file(fgm)
    assert (f["architecture"], f["quality"], f["h"], f["w"]) == \
        (arch, 1, 64, 96)
    model = codec.load_model(arch, 1, weights, "cpu")
    x = torch.from_numpy(load_image(ppm))[None]
    out = model.compress(pad_image(x, compute_padding(64, 96, min_div=64)[0]))
    y = model.decompress_y(f["strings"], f["shape"], **f["kwargs"])
    torch.testing.assert_close(y, out["y_hat"], rtol=0, atol=0)


def test_video_file_round_trip(tmp_path, monkeypatch):
    """One seed-initialised ssf2020 serves the CLI's encode and decode (its
    build and update take ~11 s on the CPU); its encoder's reconstructions
    are kept to hold the decoded frames to."""
    model = codec.load_video_model(5, None, "cpu")
    recs = []
    compress = model.compress

    def compress_keeping_reconstructions(frames):
        strings, shapes, details = compress(frames, details=True)
        recs.extend(details["x_hat"])
        return strings, shapes

    model.compress = compress_keeping_reconstructions
    monkeypatch.setattr(codec, "load_video_model",
                        lambda quality, weights, device: model)
    frames = tmp_path / "frames"
    frames.mkdir()
    rs = np.random.RandomState(1)
    base = np.clip(np.cumsum(rs.normal(0, .03, (128, 128, 3)), 0) + .5, 0, 1)
    for i in range(2):  # a slight pan
        save_image(frames / f"f{i}.ppm",
                   np.roll(base, 2 * i, axis=1).astype(np.float32))
    fgmv, out = tmp_path / "v.fgmv", tmp_path / "rec"
    assert codec.main(["encode_video", str(frames), "-o", str(fgmv),
                       "--gop", "2", "--device", "cpu"]) == 0
    assert codec.main(["decode_video", str(fgmv), "-o", str(out), "--ext",
                       "ppm", "--device", "cpu"]) == 0
    with open(fgmv, "rb") as f:
        header, gops = codec.read_video_file(f)
    assert header == (5, 128, 128, 2, 2) and len(gops) == 1
    assert len(recs) == 2
    for i, x_rec in enumerate(recs):
        got = load_image(out / f"frame_{i:05d}.ppm")
        want = np.clip(x_rec[0].numpy() * 255 + .5, 0, 255).astype(int)
        assert np.abs(np.round(got * 255).astype(int) - want).max() <= 1


def test_factorized_files_cross_packages(image, tmp_path):
    import jax.numpy as jnp

    jcli = _jax_codec_cli()
    from flashgmm_tpu.zoo import create_model as j_create

    _, png = image
    argv = ["-a", "bmshj2018-factorized", "--weights", FACTORIZED]
    j_file, t_file = tmp_path / "j.fgm", tmp_path / "t.fgm"
    assert jcli.main(["encode", str(png), "-o", str(j_file), *argv]) == 0
    assert codec.main(["encode", str(png), "-o", str(t_file), *argv,
                       "--device", "cpu"]) == 0
    jm = j_create("bmshj2018-factorized", 1, weights_path=FACTORIZED)
    jm.update(force=False)
    tm = codec.load_model("bmshj2018-factorized", 1, FACTORIZED, "cpu")

    def jax_symbols(path):
        with open(path, "rb") as f:
            assert f.read(4) == jcli.MAGIC
            f.read(6)
            shape = jcli._shape_from_list(jcli._read_stream(f)[1])
            strings = list(jcli._read_stream(f))
        return np.asarray(jm.entropy_bottleneck.decompress(strings[0], shape))

    def port_symbols(path):
        f = codec.read_file(path)
        return tm.decompress_y(f["strings"], f["shape"]).numpy()

    for path in (j_file, t_file):
        np.testing.assert_array_equal(port_symbols(path), jax_symbols(path))
    # the port's CLI decodes JAX's file, and JAX's CLI the port's
    assert codec.main(["decode", str(j_file), "-o", str(tmp_path / "a.ppm"),
                       "--weights", FACTORIZED, "--device", "cpu"]) == 0
    assert jcli.main(["decode", str(t_file), "-o", str(tmp_path / "b.png"),
                      "--weights", FACTORIZED]) == 0
    del jnp


# -- the host tool CLIs -------------------------------------------------------

def test_bench_equal_to_jax(image, tmp_path, capsys):
    from flashgmm_tpu.utils.bench.__main__ import main as j_main
    from flashgmm_tpu_torch.utils.bench.__main__ import main

    d = tmp_path / "imgs"
    d.mkdir()
    os.symlink(image[1], d / "a.png")
    for codec_name, qualities in (("jpeg", ["50", "90"]),
                                  ("webp", ["50"]), ("jpeg2000", ["20"])):
        docs = []
        for fn, name in ((main, "t"), (j_main, "j")):
            out = tmp_path / f"{name}.json"
            assert fn([codec_name, str(d), "-q", *qualities, "-o",
                       str(out)]) == 0
            docs.append(json.loads(out.read_text()))
        t, j = docs
        assert t["name"] == j["name"] == codec_name
        assert t["results"]["bpp"] == j["results"]["bpp"]
        for key in ("psnr-rgb", "ms-ssim-rgb"):
            np.testing.assert_allclose(t["results"][key], j["results"][key],
                                       rtol=0, atol=METRIC_ATOL)
    capsys.readouterr()


def test_binary_codecs_refuse_without_their_binaries(image):
    from flashgmm_tpu_torch.utils.bench.codecs import get_codec

    for name, kwargs in (("bpg", {"encoder_path": "no-such-bpgenc"}),
                         ("vtm", {"build_dir": "/no/such/dir"}),
                         ("hm", {"build_dir": "/no/such/dir"}),
                         ("av1", {"build_dir": "/no/such/dir"}),
                         ("tfci", {"tfci_path": "/no/such/tfci.py"})):
        with pytest.raises(RuntimeError, match="binary"):
            get_codec(name, **kwargs).run(image[1], 30)
    bpg = get_codec("bpg")
    assert bpg.encode_cmd("i.png", 30, "o.bpg")[:2] == ["bpgenc", "-o"]
    with pytest.raises(ValueError):
        bpg.encode_cmd("i.png", 99, "o.bpg")


def test_find_close_equal_to_jax(image, capsys):
    from flashgmm_tpu.utils.find_close.__main__ import main as j_main
    from flashgmm_tpu_torch.utils.find_close.__main__ import main

    def parse(line):
        fields = dict(f.split("=") for f in line.replace("(", "")
                      .replace(")", "").replace(",", "").split())
        return {k: float(v) for k, v in fields.items()}

    for metric, target in (("bpp", "1.0"), ("psnr-rgb", "30")):
        outs = []
        for fn in (main, j_main):
            assert fn(["jpeg", str(image[1]), target, "-m", metric]) == 0
            outs.append(parse(capsys.readouterr().out.strip()))
        assert outs[0]["quality"] == outs[1]["quality"]
        np.testing.assert_allclose(list(outs[0].values()),
                                   list(outs[1].values()), rtol=0,
                                   atol=1e-4)  # printed to 4 decimals


def test_plot_as_jax(tmp_path, capsys):
    from flashgmm_tpu.utils.plot.__main__ import main as j_main
    from flashgmm_tpu_torch.utils.plot.__main__ import main
    from flashgmm_tpu_torch.utils.video.plot.__main__ import main as v_main

    res = {"name": "toy", "results": {"bpp": [0.6, 0.3],
                                      "psnr-rgb": [31.0, 28.0],
                                      "ms-ssim-rgb": [0.98, 0.95]}}
    f = tmp_path / "toy.json"
    f.write_text(json.dumps(res))
    for fn, name in ((main, "t"), (j_main, "j"), (v_main, "v")):
        out = tmp_path / f"{name}.png"
        assert fn(["-f", str(f), "-o", str(out), "-m", "ms-ssim-rgb"]) == 0
        assert out.stat().st_size > 0
    with pytest.raises(SystemExit):
        main(["-f", str(f), "--backend", "plotly"])
    capsys.readouterr()


def test_video_bench_commands_and_metrics(tmp_path):
    from flashgmm_tpu.utils.video.bench.__main__ import \
        _frame_metrics as j_metrics
    from flashgmm_tpu_torch.utils.video.bench.__main__ import (
        _ffmpeg_decode_cmd, _ffmpeg_encode_cmd, _frame_metrics,
        _vtm_decode_cmd, _vtm_encode_cmd, main)

    enc = _ffmpeg_encode_cmd("libx265", "s.yuv", 640, 480, 30, 27, 16,
                             "o.mkv")
    assert enc[0] == "ffmpeg" and "-qp" in enc and "libx265" in enc
    dec = _ffmpeg_decode_cmd("o.mkv", 640, 480, "r.yuv")
    assert dec[0] == "ffmpeg" and "rawvideo" in dec
    enc = _vtm_encode_cmd("/b", "cfg", "s.yuv", 640, 480, 30, 32, 16,
                          "o.bin")
    assert enc[0].endswith("EncoderAppStatic")
    assert "--InputChromaFormat=420" in enc
    assert _vtm_decode_cmd("/b", "o.bin", "r.yuv")[0].endswith(
        "DecoderAppStatic")

    w, h, n = 32, 16, 2
    rs = np.random.RandomState(3)
    orig = rs.randint(0, 256, n * w * h * 3 // 2).astype(np.uint8)
    rec = np.clip(orig.astype(int) + rs.randint(-3, 4, orig.size), 0, 255)
    orig.tofile(tmp_path / "o.yuv")
    rec.astype(np.uint8).tofile(tmp_path / "r.yuv")
    got = _frame_metrics(tmp_path / "o.yuv", tmp_path / "r.yuv", w, h, n)
    ref = j_metrics(tmp_path / "o.yuv", tmp_path / "r.yuv", w, h, n)
    np.testing.assert_allclose(got, ref, rtol=0, atol=METRIC_ATOL)
    seq = tmp_path / f"s_{w}x{h}_30fps_420_8bit.yuv"
    orig.tofile(seq)
    with pytest.raises(RuntimeError, match="not found"):
        main(["vtm", str(seq), "-q", "32", "-f", "2", "--build-dir",
              "/no/such/dir"])


# -- profiler, datasets, basic layers ----------------------------------------

def test_phase_timer_trace_annotate(tmp_path):
    from flashgmm_tpu_torch.utils.profiler import PhaseTimer, annotate, trace

    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("a", result=torch.zeros(2)):
            pass
    with timer.phase("b", result={"x": [torch.ones(1)]}):
        pass
    rep = timer.report()
    assert rep["a"]["count"] == 3 and rep["b"]["count"] == 1
    assert rep["a"]["total_s"] >= 0 and "mean_ms" in rep["b"]
    assert str(timer).splitlines()[0].startswith("a ")

    @annotate("double")
    def double(x):
        return 2 * x

    with trace(str(tmp_path / "tr")) as prof:
        assert float(double(torch.ones(())).item()) == 2.0
    names = {e.name for e in prof.events()}
    assert "double" in names
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_datasets_equal_to_jax(tmp_path):
    from flashgmm_tpu.datasets import CacheDataset as JCache
    from flashgmm_tpu.datasets import PreGeneratedMemmapDataset as JMemmap
    from flashgmm_tpu.datasets import StackDataset as JStack
    from flashgmm_tpu_torch.datasets import (CacheDataset, NdArrayDataset,
                                             PreGeneratedMemmapDataset,
                                             StackDataset)

    a = NdArrayDataset(np.arange(10))
    b = NdArrayDataset((np.arange(10) * 2, np.arange(10) * 3))
    for cache_cls, stack_cls in ((CacheDataset, StackDataset),
                                 (JCache, JStack)):
        c = cache_cls(a)
        assert len(c) == 10 and c[5] == 5 and c[5] == 5
        s = stack_cls(a, b)
        assert len(s) == 10 and s[2] == (2, (4, 6))
    with pytest.raises(ValueError):
        StackDataset(a, NdArrayDataset(np.arange(3)))

    data = np.random.RandomState(0).rand(7 * 3 * 4 + 5).astype(np.float32)
    path = tmp_path / "samples.bin"
    data.tofile(path)
    t, j = PreGeneratedMemmapDataset(path, (3, 4)), JMemmap(path, (3, 4))
    assert len(t) == len(j) == 7
    for i in range(7):
        np.testing.assert_array_equal(t[i], j[i])
        assert isinstance(t[i], np.ndarray) and t[i].shape == (3, 4)


def test_basic_layers_equal_to_jax():
    import jax.numpy as jnp

    from flashgmm_tpu.layers import basic as jb
    from flashgmm_tpu_torch.layers import (Interleave, Lambda, NamedLayer,
                                           Reshape, Transpose)

    x = np.arange(2 * 3 * 5 * 12, dtype=np.float32).reshape(2, 3, 5, 12)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for port, ref, arg in ((Interleave(3), jb.Interleave(3), x),
                           (Interleave(4), jb.Interleave(4), x),
                           (Transpose((0, 3, 1, 2)),
                            jb.Transpose((0, 3, 1, 2)), x),
                           (Reshape((5, 3, 12)), jb.Reshape((5, 3, 12)), x),
                           (Lambda(lambda v: v * 2 + 1),
                            jb.Lambda(lambda v: v * 2 + 1), x),
                           (NamedLayer("n"), jb.NamedLayer("n"), x)):
        got = port(torch.from_numpy(arg)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(arg))))
    assert NamedLayer("n").name == "n"
    del t, j


# -- zoo.torch_export ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["cheng2020-anchor-checkerboard-gmm",
                                  "bmshj2018-hyperprior"])
def test_torch_export_equal_to_jax(arch):
    from flax import nnx

    from flashgmm_tpu.registry import MODELS as J_MODELS
    from flashgmm_tpu.zoo.torch_export import export_torch_state_dict as j_x
    from flashgmm_tpu_torch.registry import MODELS as T_MODELS
    from flashgmm_tpu_torch.zoo import export_torch_state_dict, load_jax_params
    from torch_port_model_pairs import jax_params

    kw = ({"N": 32, "K": 2} if "gmm" in arch else {"N": 32, "M": 48})
    jm = J_MODELS[arch](**kw, rngs=nnx.Rngs(0))
    jm.update(update_quantiles=True)
    tm = T_MODELS[arch](**kw, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update()
    got, ref = export_torch_state_dict(tm), j_x(jm)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got[k].dtype == np.asarray(ref[k]).dtype, k


@pytest.mark.parametrize("which", ["ckbd", "elic"])
def test_convert_then_export_is_identity(which):
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboardGMMv2,
                                           Elic2022GMM)
    from flashgmm_tpu_torch.zoo import (export_torch_state_dict,
                                        load_torch_state_dict)

    path = REPO / "tests" / "expected" / "reference" / \
        f"model_interop_{which}.npz"
    if not path.exists():
        pytest.skip("model interop goldens not recorded")
    golden = np.load(path)
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd/")}
    m = (Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, device="cpu")
         if which == "ckbd" else Elic2022GMM(N=64, M=160, K=4, device="cpu"))
    load_torch_state_dict(m, sd)
    out = export_torch_state_dict(m)
    assert set(out) <= set(sd)
    for k, v in out.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    # what the export leaves out: constants that the reference's
    # constructor defines (reparametrization and lower-bound constants, the
    # EntropyBottleneck's target, the context convs' masks, the scale bound)
    left = set(sd) - set(out)
    assert all(k.endswith(("pedestal", ".bound", ".target", ".mask",
                           ".scale_bound")) for k in left), sorted(left)
