"""The port's point-cloud codecs coding against the JAX package's, on the
CPU: the zoo's shipped weights, the reference format's round trip, the
float16 position mode and the JAX zoo's PointNet width.

Inputs are the held-out clouds of tools/train_pointcloud_artifact.py
(RandomState(999), 1024 points, batch 1). Both packages build their
tables with ``update(force=True, update_quantiles=True)``.

Held:
- both shipped weight files load strictly (every parameter present, no
  key left over) into the port's zoo models;
- the port's round trip: each of the four codecs' strings decode to the
  encoder's quantized latents (symbols + medians) bit for bit;
- sfu-pcc-rec-pointnet (latent 256, the shipped weights) on 2 of the 8
  held-out clouds through both packages: the symbols of the port's
  strings against JAX's differ in at most 1 % of the places (0 of 512
  measured: the strings are equal), the bits per point equal, the
  chamfer distance within 1 % of JAX's (hrtzxf2022-pcc-rec's in
  test_torch_port_pointcloud.py);
- the JAX zoo's fault: its ``sfu-pcc-rec-pointnet`` q1 builds
  ``latent_dim=512`` and cannot ``update`` with the shipped 256-wide
  file; the port's zoo model (256 wide) codes the bytes of a JAX model
  built at 256 with that file;
- the float16 position mode: the port model's position strings equal
  those of JAX's position codec on the same latent positions (the raw
  float16 of FPS-sampled input points) and decode to JAX's values; the
  training forward's position likelihoods are 2^-16;
- ``Hrtzxf2022PccModel`` is the folding model, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.losses.pointcloud import chamfer_distance as j_chamfer
from flashgmm_tpu.models.pointcloud import hrtzxf2022 as JH
from flashgmm_tpu.models.pointcloud import sfu_pointnet as JPN
from flashgmm_tpu.zoo import image_models as j_image_models
from flashgmm_tpu.zoo.npz import load_npz_weights
from flashgmm_tpu_torch.losses import chamfer_distance
from flashgmm_tpu_torch.models import pointcloud as TMOD
from flashgmm_tpu_torch.registry import MODELS
from flashgmm_tpu_torch.zoo import image_models, load_npz
from torch_port_pcc import (held_out, jax_symbols, load_like, n, nbits,
                            port_symbols, t)

torch.set_num_threads(2)

CLOUDS = held_out()
HRTZXF_NPZ = "weights/pcc_hrtzxf2022_synthetic.npz"
POINTNET_NPZ = "weights/pcc_pointnet_synthetic.npz"


def _flat_bytes(obj):
    if isinstance(obj, (bytes, bytearray)):
        return [bytes(obj)]
    return [b for o in obj for b in _flat_bytes(o)]


@pytest.fixture(scope="module")
def pointnet():
    """(JAX model at latent 256, the port's zoo model), the shipped
    weights, updated."""
    jm = JPN.PointNetReconstructionPccModel(latent_dim=256, rngs=nnx.Rngs(0))
    assert load_npz_weights(jm, POINTNET_NPZ) == 31
    jm.update(force=True, update_quantiles=True)
    tm = image_models("sfu-pcc-rec-pointnet", 1, pretrained=True,
                      device="cpu").eval()
    tm.update(force=True, update_quantiles=True)
    return jm, tm


@pytest.mark.parametrize("arch,path,count", [
    ("hrtzxf2022-pcc-rec", HRTZXF_NPZ, 252),
    ("sfu-pcc-rec-pointnet", POINTNET_NPZ, 31)])
def test_shipped_files_load_strictly(arch, path, count):
    model = MODELS[arch](device="cpu", **(
        {"latent_dim": 256} if "pointnet" in arch else {}))
    assert load_npz(model, path) == count == len(model.state_dict())
    with np.load(path) as data:
        assert len(data.files) == count


def _encoder_latents(model, x):
    """[(EntropyBottleneck, the latent it codes, [B, H, W, C])] of the
    encoder, before quantization, as ``compress`` makes them."""
    with torch.inference_mode():
        if hasattr(model, "encoder"):
            _, _, _, xyzs, feats = model.encoder(x, model.pre_conv(x))
            z = model.latent_codec["xyz"].analysis(xyzs)
            return [(model.latent_codec["feat"].entropy_bottleneck,
                     feats[:, :, None, :]),
                    (model.latent_codec["xyz"].entropy_bottleneck,
                     z[:, :, None, :])]
        return [(model.entropy_bottleneck,
                 model._encode_latent(x)[:, None, None, :])]


@pytest.mark.parametrize("arch", ["hrtzxf2022-pcc-rec",
                                  "sfu-pcc-rec-pointnet",
                                  "sfu-pcc-rec-pointnet2", "folding-pcc-rec"])
def test_round_trip_symbols_exact(arch):
    model = MODELS[arch](generator=torch.Generator().manual_seed(7),
                         device="cpu", num_points=1024).eval()
    model.update(force=True, update_quantiles=True)
    x = t(CLOUDS[:2])
    c = model.compress(x)
    got = port_symbols(model, c["strings"], c["shape"])
    for (eb, y), g in zip(_encoder_latents(model, x), got):
        want = eb.quantize(y, "dequantize", eb._medians(tuple(y.shape)))
        assert torch.equal(g, want)
    x_hat = model.decompress(c["strings"], c["shape"])["x_hat"]
    assert x_hat.shape[0] == 2 and bool(torch.isfinite(x_hat).all())


def test_pointnet_held_out_clouds_match_jax(pointnet):
    jm, tm = pointnet
    flips = total = 0
    for x in CLOUDS[:2]:
        x = x[None]
        jc = jm.compress(jnp.asarray(x))
        jr = jm.decompress(jc["strings"], jc["shape"])
        tc = tm.compress(t(x))
        tr = tm.decompress(tc["strings"], tc["shape"])
        for a, b in zip(port_symbols(tm, tc["strings"], tc["shape"]),
                        jax_symbols(jm, jc["strings"], jc["shape"])):
            flips += int((n(a) != b).sum())
            total += b.size
        assert nbits(tc["strings"]) == nbits(jc["strings"])
        want = float(j_chamfer(jr["x_hat"], jnp.asarray(x)))
        got = float(chamfer_distance(tr["x_hat"], t(x)))
        assert abs(got / want - 1) <= 0.01, (got, want)
    assert total == 2 * 256
    assert flips <= 0.01 * total, (flips, total)


def test_jax_zoo_pointnet_fault_and_port_zoo_width(pointnet):
    jz = j_image_models("sfu-pcc-rec-pointnet", 1, pretrained=True)
    assert jz.latent_dim == 512
    with pytest.raises(ValueError, match="256"):
        jz.update(force=True, update_quantiles=True)
    jm, tm = pointnet
    assert tm.latent_dim == 256
    x = CLOUDS[:1]
    assert _flat_bytes(tm.compress(t(x))["strings"]) == _flat_bytes(
        jm.compress(jnp.asarray(x))["strings"])


def test_float16_xyz_mode_matches_jax():
    cfg = {"mode": "float16"}
    jm = JH.DensityPreservingReconstructionPccModel(latent_xyzs_codec=cfg,
                                                    rngs=nnx.Rngs(0))
    tm = load_like(TMOD.DensityPreservingReconstructionPccModel(
        latent_xyzs_codec=cfg, device="cpu"), jm).eval()
    assert not list(tm.latent_codec["xyz"].parameters())
    tm.update(force=True, update_quantiles=True)
    x = t(CLOUDS[:2])
    tc = tm.compress(x)
    with torch.inference_mode():
        latent_xyzs = tm.encoder(x, tm.pre_conv(x))[3]
    jc = jm.latent_codec["xyz"].compress(jnp.asarray(n(latent_xyzs)))
    assert tc["strings"][1] == jc["strings"]
    assert tuple(tc["shape"][1]) == tuple(jc["shape"]) == (38, 3)
    got = tm.latent_codec["xyz"].decompress(tc["strings"][1],
                                            tc["shape"][1])["y_hat"]
    want = jm.latent_codec["xyz"].decompress(jc["strings"],
                                             jc["shape"])["y_hat"]
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert tm.decompress(tc["strings"], tc["shape"])["x_hat"].shape == (
        2, 1026, 3)
    out = tm(x, training=True, generator=torch.Generator())
    lk = out["likelihoods"]["latent_xyz"]
    assert tuple(lk.shape) == (2, 38, 3) and bool((lk == 2.0 ** -16).all())
    np.testing.assert_array_equal(
        n(out["latent_xyz_hat"]),
        n(out["gt_latent_xyz"]).astype(np.float16).astype(np.float32))


def test_folding_alias():
    assert TMOD.Hrtzxf2022PccModel is TMOD.FoldingPccModel
    assert MODELS["folding-pcc-rec"] is TMOD.FoldingPccModel
