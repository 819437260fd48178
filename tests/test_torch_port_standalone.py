"""The standalone codec's model card and bitstream (flashgmm_tpu_torch/
standalone/) held against the JAX package's (flashgmm_tpu/standalone/) and
the C++ binaries (csrc/standalone/), which the port builds itself
(``standalone.build``, into build/flashgmm_tpu_torch/).

Both packages' ``FactorizedPrior(N=32, M=48)`` (and the ReLU variant) carry
JAX's ``nnx.Rngs`` weights, the port's through ``zoo.load_jax_params``,
JAX's quantiles after ``update(update_quantiles=True)`` included, so the
EntropyBottleneck tables are equal:

- ``export_model_card(..., compute_gains=False)``: byte-equal cards;
- the synthesis gains: within ``GAINS_RTOL`` (g_s's float32 convs sum in
  another order than XLA's);
- pack/unpack: exact; each package's stream of the same symbols: equal
  bytes, and each decodes the other's stream to the same symbols;
- the C++ binaries decode the port's stream, and the port decodes theirs,
  within 1 level of the other side's pixels (the float g_s engines differ
  in their roundings), as tests/test_standalone.py holds JAX's;
- the relu and int16 variants; the decoder refusing garbage.
"""

import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.google import FactorizedPrior as JFactorized
from flashgmm_tpu.models.google import FactorizedPriorReLU as JFactorizedReLU
from flashgmm_tpu.standalone import export_model_card as j_export
from flashgmm_tpu.standalone.format import encode_bitstream as j_encode
from flashgmm_tpu.standalone.format import pack_bitstream as j_pack
from flashgmm_tpu.standalone.format import unpack_bitstream as j_unpack
from flashgmm_tpu_torch.models import FactorizedPrior, FactorizedPriorReLU
from flashgmm_tpu_torch.standalone import (build_binaries, decode_bitstream,
                                           encode_bitstream,
                                           export_model_card, synthesis_gains)
from flashgmm_tpu_torch.standalone.format import (encode_symbols,
                                                  pack_bitstream,
                                                  unpack_bitstream)
from flashgmm_tpu_torch.zoo import load_jax_params
from torch_port_model_pairs import jax_params

torch.set_num_threads(2)

GAINS_RTOL = 1e-4  # measured: at most 2.1e-5 apart (seeds 0 and 1)


def _pair(jcls, tcls, seed):
    jm = jcls(N=32, M=48, rngs=nnx.Rngs(seed))
    jm.update(update_quantiles=True)
    tm = tcls(32, 48, device="cpu")
    tm.load_state_dict(load_jax_params(jax_params(jm), tm), strict=True)
    tm.update(force=True)
    return jm, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(JFactorized, FactorizedPrior, 0)


@pytest.fixture(scope="module")
def binaries():
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    return build_binaries()


def _image(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = np.cumsum(rng.normal(0, 0.02, (h, w, 3)), axis=1) + 0.5
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _write_ppm(path, img):
    h, w = img.shape[:2]
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())


def _read_ppm(path):
    data = path.read_bytes()
    head = data.split(b"\n", 3)
    w, h = map(int, head[1].split())
    return np.frombuffer(head[3], np.uint8).reshape(h, w, 3)


def _u8(x):
    return np.clip(x * 255 + 0.5, 0, 255).astype(np.uint8).astype(int)


def test_card_bytes_equal_jax(pair, tmp_path):
    jm, tm = pair
    n_j = j_export(jm, str(tmp_path / "j.fgsam"), compute_gains=False)
    n_t = export_model_card(tm, str(tmp_path / "t.fgsam"),
                            compute_gains=False)
    assert n_j == n_t
    assert (tmp_path / "j.fgsam").read_bytes() == \
        (tmp_path / "t.fgsam").read_bytes()


def test_gains_close_to_jax(pair):
    from flashgmm_tpu.standalone import synthesis_gains as j_gains

    jm, tm = pair
    got, ref = synthesis_gains(tm), j_gains(jm)
    assert got.shape == ref.shape == (48,)
    np.testing.assert_allclose(got, ref, rtol=GAINS_RTOL)


def test_pack_unpack_exact_and_equal_to_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    symbols = rng.integers(-5, 6, (3, 4, 48)).astype(np.int32)
    symbols[:, :, 10:20] = 0  # some inactive channels
    data = pack_bitstream(symbols, tm, img_w=64, img_h=48)
    assert data == j_pack(symbols, jm, img_w=64, img_h=48)
    out, w, h = unpack_bitstream(data, tm)
    assert (w, h) == (64, 48)
    np.testing.assert_array_equal(out, symbols)


def test_streams_cross_packages(pair):
    """JAX's stream of an image decodes in the port to JAX's symbols, and
    the port's in JAX to the port's."""
    jm, tm = pair
    img = _image(50, 70, seed=2)
    j_data = j_encode(jm, img)
    t_data = encode_bitstream(tm, img)
    j_syms, jw, jh = j_unpack(j_data, jm)
    t_syms, tw, th = unpack_bitstream(t_data, tm)
    np.testing.assert_array_equal(unpack_bitstream(j_data, tm)[0], j_syms)
    np.testing.assert_array_equal(j_unpack(t_data, jm)[0], t_syms)
    assert (jw, jh) == (tw, th) == (70, 50)
    np.testing.assert_array_equal(t_syms, encode_symbols(tm, img)[0])
    rec = decode_bitstream(tm, t_data)
    assert rec.shape == (50, 70, 3)
    assert np.all(rec >= 0) and np.all(rec <= 1)


def _cpp_round_trip(enc, dec, card, tm, img, tmp_path, flags=()):
    """Both directions between the binaries and the port: (max |level|
    difference, C++ encoder's stream, the port's stream)."""
    ppm = tmp_path / "in.ppm"
    _write_ppm(ppm, img)
    bs_cpp = tmp_path / "cpp.fgs"
    subprocess.run([enc, *flags, card, ppm, bs_cpp], check=True,
                   capture_output=True)
    rec_ppm = tmp_path / "rec.ppm"
    subprocess.run([dec, *flags, card, bs_cpp, rec_ppm], check=True,
                   capture_output=True)
    worst = np.abs(_read_ppm(rec_ppm).astype(int)
                   - _u8(decode_bitstream(tm, bs_cpp.read_bytes()))).max()
    bs_py = tmp_path / "py.fgs"
    bs_py.write_bytes(encode_bitstream(tm, img))
    rec2_ppm = tmp_path / "rec2.ppm"
    subprocess.run([dec, *flags, card, bs_py, rec2_ppm], check=True,
                   capture_output=True)
    worst = max(worst, np.abs(_read_ppm(rec2_ppm).astype(int) - _u8(
        decode_bitstream(tm, bs_py.read_bytes()))).max())
    return worst, bs_cpp.read_bytes(), bs_py.read_bytes()


def test_cpp_binaries_and_port_cross(binaries, pair, tmp_path):
    enc, dec = binaries
    _, tm = pair
    card = tmp_path / "t.fgsam"
    export_model_card(tm, str(card))
    img = _image(seed=3)
    worst, cpp, _ = _cpp_round_trip(enc, dec, card, tm, img, tmp_path)
    assert worst <= 1
    # the C++ encoder's symbols decode in the port
    syms, w, h = unpack_bitstream(cpp, tm)
    assert syms.shape == (3, 4, 48) and (w, h) == (64, 48)


def test_relu_and_int16_variants(binaries, tmp_path):
    enc, dec = binaries
    _, tm = _pair(JFactorizedReLU, FactorizedPriorReLU, 1)
    card = tmp_path / "relu.fgsam"
    export_model_card(tm, str(card))
    img = _image(seed=5)
    worst, _, _ = _cpp_round_trip(enc, dec, card, tm, img, tmp_path)
    assert worst <= 1
    recs = {}
    ppm = tmp_path / "in.ppm"
    for name, flags in (("float", []), ("int16", ["--int16"])):
        bs = tmp_path / f"{name}.fgs"
        r = subprocess.run([enc, *flags, card, ppm, bs], check=True,
                           capture_output=True, text=True)
        assert f"g_a({name})" in r.stdout
        rec = tmp_path / f"{name}.ppm"
        subprocess.run([dec, *flags, card, bs, rec], check=True,
                       capture_output=True)
        recs[name] = _read_ppm(rec).astype(int)
    assert np.abs(recs["float"] - recs["int16"]).mean() < 3.0


def test_header_fields(pair):
    _, tm = pair
    data = encode_bitstream(tm, _image(50, 70, seed=6))
    assert data[:8] == b"FGSAB001"
    w, h, m, down, flags = struct.unpack_from("<HHHBB", data, 8)
    assert (w, h, m, down, flags) == (70, 50, 48, 16, 1)
    with pytest.raises(ValueError, match="magic"):
        unpack_bitstream(b"XXXXXXXX" + data[8:], tm)


def test_decoder_rejects_garbage(binaries, pair, tmp_path):
    """fgsc_decode fails cleanly (nonzero exit, no crash or hang) on a
    corrupt version of the port's stream."""
    _, dec = binaries
    _, tm = pair
    card = tmp_path / "t.fgsam"
    export_model_card(tm, str(card), compute_gains=False)
    blob = encode_bitstream(tm, _image(seed=9))
    cases = {
        "bad_magic": b"XXXXXXXX" + blob[8:],
        "trunc_header": blob[:10],
        "trunc_body": blob[: len(blob) // 2],
        "huge_len": blob[:16 + (48 + 7) // 8]
        + (0xFFFFFFFF).to_bytes(4, "little") + blob[-32:],
        "garbage": np.random.RandomState(0).bytes(64),
    }
    for name, data in cases.items():
        bad = tmp_path / f"{name}.fgs"
        bad.write_bytes(data)
        r = subprocess.run([dec, card, bad, tmp_path / "out.ppm"],
                           capture_output=True, timeout=60)
        assert r.returncode != 0, name
