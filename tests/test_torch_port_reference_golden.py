"""The port's reference-format coding held against the recorded goldens of
the original C++ coder and the reference networks.

1. Every case of tests/test_reference_golden.py, through the port's own
   build of csrc/rans.cpp (``flashgmm_tpu_torch.ans.cext``): the PMF
   quantizer, the table path (encode, decode, streaming decode), the GSM
   host coder in modes 0-2 (SIMD-insensitive), the K=4 GMM host coder in
   modes 0-2 under USE_SIMD 0 and 1, in both directions, and FLASHGMM_DEBUG's
   refusal of a bad CDF. Also the build itself: where it lands, that
   processes building at once all load it, and that a failed build makes
   every call raise with the compiler's message.
2. The model-level interop of tests/test_model_interop.py:128-193 for the
   checkerboard flagship and ELIC, on the port's models loaded from the
   reference state dicts (``sd/*``) through ``zoo/torch_convert.py``, in
   host-math mode (FLASHGMM_HOST_MATH=1): the z string's bytes, every
   pass's container byte-identical given the file's parameters, every
   reference pass decoded exactly, and the whole model's compress: symbols,
   abs_max and zero bitmaps equal the reference's, and its decompress gives
   the reference's x_hat within 1e-3.

Imports no JAX: the goldens are the reference's own recordings.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flashgmm_tpu_torch.ans import cext
from flashgmm_tpu_torch.ans.pmf_to_cdf import pmf_to_quantized_cdf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DIR = ROOT / "tests" / "expected" / "reference"


def _load(name):
    path = DIR / name
    if not path.exists():
        pytest.skip(f"golden {name} not recorded")
    return np.load(path)


# -- 1. the host coder against the reference C++ coder's recordings ----------


def test_host_coder_builds_into_the_ports_build_directory():
    assert cext.available()
    path = cext.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "flashgmm_tpu_torch"
    assert path.name.startswith("librans_")


def test_pmf_to_quantized_cdf_bit_exact():
    z = _load("pmf_to_quantized_cdf.npz")
    for i in range(int(z["n"])):
        ours = np.asarray(pmf_to_quantized_cdf(z[f"pmf_{i}"], 16), np.int32)
        assert np.array_equal(ours, z[f"cdf_{i}"]), f"pmf {i}"


def test_table_path_encode_byte_identical():
    t = _load("table_path.npz")
    ours = cext.encode_with_indexes(t["symbols"], t["indexes"], t["cdfs"],
                                    t["cdfs_sizes"], t["offsets"])
    assert ours == t["bitstream"].tobytes()


def test_table_path_decodes_reference_bitstream():
    t = _load("table_path.npz")
    dec = cext.decode_with_indexes(t["bitstream"].tobytes(), t["indexes"],
                                   t["cdfs"], t["cdfs_sizes"], t["offsets"])
    assert np.array_equal(dec, t["symbols"])


def test_table_path_streaming_decoder_on_reference_bitstream():
    t = _load("table_path.npz")
    sd = cext.StreamingDecoder(t["bitstream"].tobytes(), t["cdfs"],
                               t["cdfs_sizes"], t["offsets"])
    idx = t["indexes"]  # in chunks, as an autoregressive model decodes
    outs = [sd.decode(idx[:100]), sd.decode(idx[100:101]),
            sd.decode(idx[101:])]
    sd.close()
    assert np.array_equal(np.concatenate(outs), t["symbols"])


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gsm_encode_byte_identical(mode):
    g = _load(f"gsm_mode{mode}_simd0.npz")
    ours = cext.encode_gsm_host(g["symbols"], g["scales"], approx_mode=mode)
    assert ours == g["bitstream"].tobytes()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gsm_simd_insensitive_and_simd1_golden(mode):
    """The reference's GSM streams are equal under USE_SIMD 0 and 1, and
    the port's (scalar-order) GSM encoder writes the simd=1 recording."""
    g0 = _load(f"gsm_mode{mode}_simd0.npz")
    g1 = _load(f"gsm_mode{mode}_simd1.npz")
    assert g0["bitstream"].tobytes() == g1["bitstream"].tobytes()
    ours = cext.encode_gsm_host(g1["symbols"], g1["scales"], approx_mode=mode)
    assert ours == g1["bitstream"].tobytes()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gsm_decodes_reference_bitstream(mode):
    g = _load(f"gsm_mode{mode}_simd0.npz")
    dec = cext.decode_gsm_host(g["bitstream"].tobytes(), g["scales"],
                               int(g["max_bs_value"]), approx_mode=mode)
    assert np.array_equal(dec, g["symbols"])


@pytest.mark.parametrize("simd", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gmm_k4_encode_byte_identical(mode, simd):
    """Both of the reference's CDF paths (scalar: libm exp, a sequential
    sum; AVX2: Cephes exp, a pairwise horizontal add) write different
    streams, and the port's host coder writes each."""
    g = _load(f"gmm_k4_mode{mode}_simd{simd}.npz")
    ours = cext.encode_gmm_host(g["symbols"], g["scales"], g["means"],
                                g["weights"], approx_mode=mode, use_simd=simd)
    assert ours == g["bitstream"].tobytes()


@pytest.mark.parametrize("simd", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gmm_k4_decodes_reference_bitstream(mode, simd):
    g = _load(f"gmm_k4_mode{mode}_simd{simd}.npz")
    dec = cext.decode_gmm_host(g["bitstream"].tobytes(), g["scales"],
                               g["means"], g["weights"],
                               int(g["max_bs_value"]), approx_mode=mode,
                               use_simd=simd)
    assert np.array_equal(dec, g["symbols"])


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


def test_debug_mode_rejects_bad_cdf():
    """FLASHGMM_DEBUG=1 makes the host coder check its CDF rows (the
    reference's assert_cdfs, rans_interface.cpp:70-80)."""
    out = _run("import numpy as np\n"
               "from flashgmm_tpu_torch.ans import cext\n"
               "rows = np.array([[100, 50, 65535]], np.uint16)\n"
               "try:\n"
               "    cext.encode_rows(np.array([0], np.int32), rows, 0)\n"
               "except ValueError:\n"
               "    print('REJECTED')\n", FLASHGMM_DEBUG="1")
    assert "REJECTED" in out.stdout, out.stderr


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build the library into one empty directory at once:
    each compiles to a name of its own and renames it into place, so every
    one loads a whole library and codes the golden table stream."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "import numpy as np\n"
            "from flashgmm_tpu_torch.ans import cext\n"
            "cext.BUILD_DIR = Path(sys.argv[1])\n"
            "t = np.load(sys.argv[2])\n"
            "ours = cext.encode_with_indexes(t['symbols'], t['indexes'], "
            "t['cdfs'], t['cdfs_sizes'], t['offsets'])\n"
            "print('OK' if ours == t['bitstream'].tobytes() else 'BAD')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               str(DIR / "table_path.npz")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(out.strip() == "OK" for out, _ in outs), outs
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        cext.library_path().name]


def test_a_failed_build_makes_every_call_raise(tmp_path, monkeypatch):
    bad = tmp_path / "rans.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cext, "SOURCE", bad)
    monkeypatch.setattr(cext, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cext, "_lib", None)
    monkeypatch.setattr(cext, "_build_error", None)
    assert not cext.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cext.encode_rows(np.zeros(1, np.int32), np.array([[0, 65535]],
                                                         np.uint16), 0)
    with pytest.raises(RuntimeError, match="not available"):
        cext.StreamingDecoder(b"\0" * 8, np.zeros((1, 3), np.int32),
                              [3], [0])
    assert not list((tmp_path / "build").glob("*.so"))


# -- 2. model-level interop with the reference networks ----------------------


def nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1))))


def nchw(t):
    return np.transpose(t.detach().cpu().numpy(), (0, 3, 1, 2))


@pytest.fixture(scope="module", params=["ckbd", "elic"])
def arch(request):
    if not (DIR / f"model_interop_{request.param}.npz").exists():
        pytest.skip(f"{request.param} model interop goldens not recorded")
    return request.param


@pytest.fixture(scope="module")
def golden(arch):
    return _load(f"model_interop_{arch}.npz")


@pytest.fixture(scope="module")
def model(arch, golden):
    from flashgmm_tpu_torch.models import (Cheng2020AnchorCheckerboardGMMv2,
                                           Elic2022GMM)
    from flashgmm_tpu_torch.zoo.torch_convert import load_torch_state_dict

    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd/")}
    if arch == "ckbd":
        m = Cheng2020AnchorCheckerboardGMMv2(N=64, K=4, device="cpu")
    else:
        m = Elic2022GMM(N=64, M=160, K=4, device="cpu")
    unused = load_torch_state_dict(m, sd)
    # the constants of the GDN reparametrizations and the lower bounds
    assert all(k.endswith(("pedestal", ".bound")) for k in unused), unused
    return m


@pytest.fixture
def host_math(monkeypatch):
    monkeypatch.setenv("FLASHGMM_HOST_MATH", "1")


def _gms(model, arch):
    """Every GaussianMixtureConditional in coding order."""
    ycodec = model.latent_codec.latent_codec["y"]
    ckbds = [ycodec] if arch == "ckbd" else [
        ycodec.latent_codec[f"y{k}"] for k in range(len(ycodec.groups))]
    return [c.latent_codec["y"].gaussian_mixture_conditional for c in ckbds]


def test_z_string_bytes(golden, model, host_math):
    """The EntropyBottleneck's z string, with no tensor transplanted: the
    tables come from the checkpoint and the symbols from the port's g_a and
    h_a."""
    hyper = model.latent_codec.latent_codec["hyper"]
    with torch.inference_mode():
        y = model.g_a(nhwc(golden["x"]))
        out = hyper.compress(y)
    [z_strings] = out["strings"]
    assert bytes(z_strings[0]) == golden["z_string_0"].tobytes()


def test_decode_reference_z_string(golden, model):
    eb = model.latent_codec.latent_codec["hyper"].entropy_bottleneck
    h, w = golden["z"].shape[2:]
    z_hat = eb.decompress([golden["z_string_0"].tobytes()], (h, w))
    assert np.array_equal(nchw(z_hat), golden["z_hat"])


def test_encode_every_pass(arch, golden, model, host_math):
    """Each pass's container byte-identical to the reference's given the
    file's parameters (2 passes for the checkerboard, 10 for ELIC)."""
    gms = _gms(model, arch)
    for i in range(int(golden["n_passes"])):
        gm = gms[min(i // 2, len(gms) - 1)]
        (rv, abs_max, zb), y_q = gm.compress(
            *(nhwc(golden[f"pass{i}/{n}"])
              for n in ("y", "scales", "means", "weights")))
        assert bytes(rv) == golden[f"pass{i}/string"].tobytes(), i
        assert int(abs_max) == int(golden[f"pass{i}/abs_max"]), i
        assert np.array_equal(np.asarray(zb), golden[f"pass{i}/zero_bitmap"]), i
        assert np.array_equal(nchw(y_q), golden[f"pass{i}/y_hat"]), i


def test_decode_every_reference_pass(arch, golden, model, host_math):
    gms = _gms(model, arch)
    for i in range(int(golden["n_passes"])):
        gm = gms[min(i // 2, len(gms) - 1)]
        y_hat = gm.decompress(
            golden[f"pass{i}/string"].tobytes(),
            int(golden[f"pass{i}/abs_max"]),
            torch.from_numpy(golden[f"pass{i}/zero_bitmap"]),
            *(nhwc(golden[f"pass{i}/dec_{n}"])
              for n in ("scales", "means", "weights")))
        assert np.array_equal(nchw(y_hat), golden[f"pass{i}/dec_y_hat"]), i


def test_compress_symbols_and_container(golden, model, host_math):
    """The whole model's compress: the z string, each pass's abs_max and
    zero bitmap, and y_hat equal to the reference's; decompress of the
    port's own strings gives the reference's x_hat within 1e-3."""
    out = model.compress(nhwc(golden["x"]))
    *y_strings, z_strings = out["strings"]
    assert bytes(z_strings[0]) == golden["z_string_0"].tobytes()
    assert len(y_strings) == int(golden["n_passes"])
    for i, (_, abs_max, zb) in enumerate(y_strings):
        assert int(abs_max) == int(golden[f"pass{i}/abs_max"]), i
        assert np.array_equal(np.asarray(zb), golden[f"pass{i}/zero_bitmap"]), i
    assert np.array_equal(nchw(out["y_hat"]), golden["y_hat"])
    dec = model.decompress(out["strings"], out["shape"])
    assert np.abs(nchw(dec["x_hat"]) - golden["x_hat"]).max() < 1e-3
