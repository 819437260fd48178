"""The eval forwards of the port's four point-cloud codecs against the JAX
package's, on the CPU.

The JAX models run under ``nnx.jit`` (one compile each instead of eager
compiles op by op); the port's models get their parameters through
``zoo.load_jax_params``. Inputs: 2 held-out clouds of
tools/train_pointcloud_artifact.py (RandomState(999), 1024 points).

Held, each output within its atol times max(1, its largest magnitude)
(float32 sums of a few hundred products; the decoded features of JAX's
initial weights reach ~20; where the EntropyBottleneck's rounding or a
density count's ``round`` lands on the other side of .5 the outputs would
differ by far more):
- hrtzxf2022-pcc-rec on the shipped weights and on JAX's initial weights:
  x_hat, every level's reconstruction, the upsample counts, the latent
  features and positions and their likelihoods, and the encoder's ground
  truths (levels, downsample counts, mean distances), each within 1e-5
  (the likelihoods 1e-6); the predicted mean distances within 1e-5 but
  for at most 2 % of their entries: a decoded cloud repeats points (the
  cycle-fill; at JAX's initial weights 224 and 206 of the 342 points of
  the second level are repeats), and a reconstructed point equidistant
  from two latent points up to the two packages' float rounding collapses
  onto either (given the same clouds the port's ``nearby_distance_sum``
  is JAX's within 4e-6): 0, 2 of 228 and 8 of 684 entries at JAX's initial
  weights, none on the shipped weights;
- sfu-pcc-rec-pointnet on the shipped weights (latent 256) and at JAX's
  initial weights, sfu-pcc-rec-pointnet2 and folding-pcc-rec at JAX's
  initial weights: x_hat within 1e-5 and the likelihoods within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.models.pointcloud import hrtzxf2022 as JH
from flashgmm_tpu.models.pointcloud import sfu_pointnet as JPN
from flashgmm_tpu.models.pointcloud import sfu_pointnet2 as JPN2
from flashgmm_tpu.zoo.npz import load_npz_weights
from flashgmm_tpu_torch.models import pointcloud as TMOD
from torch_port_pcc import held_out, load_like, n, t

torch.set_num_threads(2)

X = held_out()[:2]

# (JAX class, port class, constructor keywords, shipped weights or None)
CASES = {
    "hrtzxf2022 shipped": (JH.DensityPreservingReconstructionPccModel,
                           TMOD.DensityPreservingReconstructionPccModel, {},
                           "weights/pcc_hrtzxf2022_synthetic.npz"),
    "hrtzxf2022 seed": (JH.DensityPreservingReconstructionPccModel,
                        TMOD.DensityPreservingReconstructionPccModel, {},
                        None),
    "pointnet shipped": (JPN.PointNetReconstructionPccModel,
                         TMOD.PointNetReconstructionPccModel,
                         {"latent_dim": 256},
                         "weights/pcc_pointnet_synthetic.npz"),
    "pointnet seed": (JPN.PointNetReconstructionPccModel,
                      TMOD.PointNetReconstructionPccModel, {}, None),
    "pointnet2 seed": (JPN2.PointNet2ReconstructionPccModel,
                       TMOD.PointNet2ReconstructionPccModel, {}, None),
    "folding seed": (JH.FoldingPccModel, TMOD.FoldingPccModel, {}, None),
}


def _close(got, want, atol, what, share=0.0):
    """got within atol * max(1, max|want|) of want, but for at most
    ``share`` of the entries."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{what}[{i}]", share)
        return
    w = np.asarray(want).astype(np.float64)
    g = n(got).astype(np.float64)
    assert g.shape == w.shape, what
    bad = np.abs(g - w) > atol * max(1.0, float(np.abs(w).max()))
    assert bad.sum() <= share * bad.size, (
        f"{what}: {int(bad.sum())} of {bad.size} entries apart, max "
        f"{np.abs(g - w).max()}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case):
    jcls, tcls, kwargs, weights = CASES[case]
    jm = jcls(**kwargs, rngs=nnx.Rngs(0))
    if weights:
        load_npz_weights(jm, weights)
    tm = load_like(tcls(**kwargs, device="cpu"), jm).eval()
    want = nnx.jit(lambda m, x: m(x, training=False))(jm, jnp.asarray(X))
    want = jax.tree.map(np.asarray, want)
    with torch.no_grad():
        got = tm(t(X), training=False)
    assert set(got) == set(want)
    for key, w in want.items():
        if w is None:
            assert got[key] is None
        elif key == "likelihoods":
            assert set(got[key]) == set(w)
            for k in w:
                _close(got[key][k], w[k], 1e-6, f"{case} likelihoods {k}")
        else:
            _close(got[key], w, 1e-5, f"{case} {key}",
                   0.02 if key == "mean_distance_hat_" else 0.0)
