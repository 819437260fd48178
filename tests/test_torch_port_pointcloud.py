"""The port's density-preserving point-cloud codec (hrtzxf2022-pcc-rec)
coding against the JAX package's, on the CPU, on the zoo's shipped
weights.

Inputs are the held-out clouds of tools/train_pointcloud_artifact.py
(RandomState(999), 1024 points, batch 1). Both packages build their
tables with ``update(force=True, update_quantiles=True)``.

Held, on 2 of the 8 held-out clouds through both packages' ``compress``
and ``decompress``: the symbols of the port's strings against JAX's
strings differ in at most 1 % of the places (0 of 608 measured: the
strings are equal), the bits per point equal, the decoded point counts
equal (1026), the chamfer distance to the input within 1 % of JAX's.
The JAX model codes eagerly, which compiles each of its many small ops
at its first call (~45 s of this file); the other codecs' coding is in
test_torch_port_pointcloud_codecs.py.
"""

import jax.numpy as jnp
import torch
from flax import nnx

from flashgmm_tpu.losses.pointcloud import chamfer_distance as j_chamfer
from flashgmm_tpu.models.pointcloud import hrtzxf2022 as JH
from flashgmm_tpu.zoo.npz import load_npz_weights
from flashgmm_tpu_torch.losses import chamfer_distance
from flashgmm_tpu_torch.zoo import image_models
from torch_port_pcc import held_out, jax_symbols, n, nbits, port_symbols, t

torch.set_num_threads(2)


def test_held_out_clouds_match_jax():
    jm = JH.DensityPreservingReconstructionPccModel(rngs=nnx.Rngs(0))
    assert load_npz_weights(jm, "weights/pcc_hrtzxf2022_synthetic.npz") \
        == 252
    jm.update(force=True, update_quantiles=True)
    tm = image_models("hrtzxf2022-pcc-rec", 1, pretrained=True,
                      device="cpu").eval()
    tm.update(force=True, update_quantiles=True)
    flips = total = 0
    for x in held_out()[:2]:
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
        assert tuple(tr["x_hat"].shape) == tuple(jr["x_hat"].shape) \
            == (1, 1026, 3)
        want = float(j_chamfer(jr["x_hat"], jnp.asarray(x)))
        got = float(chamfer_distance(tr["x_hat"], t(x)))
        assert abs(got / want - 1) <= 0.01, (got, want)
    assert total == 2 * 2 * 38 * 8
    assert flips <= 0.01 * total, (flips, total)
