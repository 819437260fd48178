"""The port's point-cloud layers against the JAX package's, on the CPU.

Inputs are made with numpy (the held-out clouds of
tools/train_pointcloud_artifact.py: RandomState(999), 1024 points) and
given to both packages; JAX's modules have their parameters moved off
their initial values (``torch_port_pcc.perturb``) and the port's load the
same values through ``zoo.load_jax_params``.

Held:
- farthest-point sampling: the indices equal JAX's exactly on the 8
  held-out clouds at 341 samples, then 114 of those, then 38;
- kNN: the neighbour sets equal JAX's (the order within a set may follow
  float rounding); on exact ties (a cloud that repeats points, as a
  decoded one does) the indices equal JAX's in order: the lower index
  first, as ``lax.top_k``; ``nearby_distance_sum``: the
  distance within 1e-6, the collapsed sets (mask) and the nearest
  indices equal as sets;
- ``select_xyzs_and_feats``: the selected indices exactly, with counts at
  exact half-integers (both round half to even) and clipped ones;
- ``query_ball_point`` and ``ball_group`` exactly; ``icosphere_directions``
  equal;
- ``_MLP`` against flax's GroupNorm on a batch of two clouds whose
  statistics differ (one is the other scaled by 10 and shifted), within
  1e-5: the statistics are per cloud;
- each layer class, EdgeConv and both SubPointConv modes among them,
  within the atol its case states: 1e-5 for float32 sums of up to 64
  products; 5e-5 for the position upsampling, which divides each
  direction by its norm (where the 43 hypotheses' mixture nearly cancels,
  the division magnifies the sum's rounding: 1.4e-5 seen); 1e-4 for the
  downsample layer, which stacks a transformer and two embeddings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from flashgmm_tpu.layers.pointcloud import hrtzxf2022 as JL
from flashgmm_tpu.layers.pointcloud import pointnet as JP
from flashgmm_tpu.layers.pointcloud import pointnet2 as JP2
from flashgmm_tpu.models.pointcloud import sfu_pointnet2 as JM2
from flashgmm_tpu_torch.layers.pointcloud import hrtzxf2022 as TL
from flashgmm_tpu_torch.layers.pointcloud import pointnet as TP
from flashgmm_tpu_torch.layers.pointcloud import pointnet2 as TP2
from flashgmm_tpu_torch.models.pointcloud import sfu_pointnet2 as TM2
from torch_port_pcc import held_out, load_like, n, perturb, t

torch.set_num_threads(2)

CLOUDS = held_out()


def _fps_levels():
    """[(points, samples)] of the encoder's three levels, for both
    packages: each level's points are JAX's samples of the level above."""
    levels, pts = [], CLOUDS
    for m in (341, 114, 38):
        idx = np.asarray(JP.farthest_point_sample(jnp.asarray(pts), m))
        levels.append((pts, idx))
        pts = np.take_along_axis(pts, idx[..., None], 1)
    return levels


def test_fps_indices_equal_jax():
    for pts, want in _fps_levels():
        got = TP.farthest_point_sample(t(pts), want.shape[1])
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(n(got), want)


def _sets(idx):
    return [[frozenset(row) for row in cloud] for cloud in np.asarray(idx)]


def test_knn_sets_equal_jax():
    (pts, idx), (sub, _), _ = _fps_levels()
    q = np.take_along_axis(pts, idx[..., None], 1)
    for query, ref, k in ((q, pts, 16), (sub, sub, 16), (pts, q, 1)):
        want = JL.knn_indices(jnp.asarray(query), jnp.asarray(ref), k)
        got = TL.knn_indices(t(query), t(ref), k)
        assert tuple(got.shape) == tuple(want.shape)
        assert _sets(n(got)) == _sets(want)


def test_knn_ties_in_jax_order():
    rs = np.random.RandomState(3)
    ref = rs.rand(2, 40, 3).astype(np.float32)
    ref[:, 20:] = ref[:, :20]  # every point twice
    ref[:, 5] = ref[:, 7]  # and a triple
    query = np.concatenate([ref[:, :10], rs.rand(2, 6, 3).astype(
        np.float32)], 1)
    for k in (1, 3, 8):
        want = np.asarray(JL.knn_indices(jnp.asarray(query), jnp.asarray(ref),
                                         k))
        np.testing.assert_array_equal(n(TL.knn_indices(t(query), t(ref), k)),
                                      want)


def test_nearby_distance_sum_matches_jax():
    (pts, idx), _, _ = _fps_levels()
    a = np.take_along_axis(pts, idx[..., None], 1)
    jd, jmask, jknn, jnn = JL.nearby_distance_sum(jnp.asarray(a),
                                                  jnp.asarray(pts), 16)
    td, tmask, tknn, tnn = TL.nearby_distance_sum(t(a), t(pts), 16)
    np.testing.assert_allclose(n(td), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(tnn), np.asarray(jnn))

    def collapsed(mask, knn):
        return [[frozenset(k[m]) for k, m in zip(kc, mc)]
                for kc, mc in zip(np.asarray(knn), np.asarray(mask))]
    assert collapsed(n(tmask), n(tknn)) == collapsed(jmask, jknn)
    assert int(n(tmask).sum()) == int(np.asarray(jmask).sum())


@pytest.mark.parametrize("rate", [3.0, 1.0 / (1 / 3), 2.5])
def test_select_indices_exact_at_half_integers(rate):
    b, nn_, s = 3, 38, 8
    rs = np.random.RandomState(5)
    unum = rs.uniform(1, s, (b, nn_)).astype(np.float32)
    unum[0, :16] = np.arange(16) / 2.0  # 0, 0.5, ..., 7.5: ties to even
    unum[1, :4] = (0.2, 9.5, 8.5, 100.0)  # clipped to [1, s]
    unum[2] = 0.5  # every group rounds to 0 -> 1 kept: the cycle-fill
    # each candidate's coordinates name it, so the output shows the indices
    ids = np.arange(b * nn_ * s, dtype=np.float32).reshape(b, nn_, s, 1)
    xyz = np.concatenate([ids, -ids, 2 * ids], -1)
    feats = np.concatenate([ids, ids + 0.5], -1)
    jx, jf = JL.select_xyzs_and_feats(jnp.asarray(xyz), jnp.asarray(feats),
                                      jnp.asarray(unum), rate)
    tx, tf = TL.select_xyzs_and_feats(t(xyz), t(feats), t(unum), rate)
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_array_equal(n(tf), np.asarray(jf))


def test_ball_query_and_ball_group_exact():
    (pts, idx), _, _ = _fps_levels()
    pts = pts[:, :512]
    centers = np.take_along_axis(pts, np.minimum(idx[:, :64], 511)[..., None],
                                 1)
    for radius, k in ((0.05, 16), (0.2, 16), (0.4, 32)):
        want = JP2.query_ball_point(radius, k, jnp.asarray(pts),
                                    jnp.asarray(centers))
        got = TP2.query_ball_point(radius, k, t(pts), t(centers))
        np.testing.assert_array_equal(n(got), np.asarray(want))
        want = JM2.ball_group(jnp.asarray(pts), jnp.asarray(centers), radius,
                              k)
        got = TM2.ball_group(t(pts), t(centers), radius, k)
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_icosphere_directions_equal():
    for level in (0, 1, 2):
        np.testing.assert_array_equal(TL.icosphere_directions(level),
                                      JL.icosphere_directions(level))


def test_mlp_groupnorm_is_per_cloud_like_flax():
    jm = perturb(JL._MLP(3, 64, 8, 1, rngs=nnx.Rngs(0)))
    tm = load_like(TL._MLP(3, 64, 8, 1), jm)
    base = CLOUDS[:1, :, None, :].repeat(4, axis=2)  # [1, n, 4, 3]
    x = np.concatenate([base, 10 * base + 3], 0)
    want = np.asarray(jm(jnp.asarray(x)))
    got = n(tm(t(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # per cloud: a cloud's output does not depend on the other cloud
    np.testing.assert_allclose(n(tm(t(x[:1]))), got[:1], rtol=0, atol=1e-5)
    # and not per point: the statistics of one point alone differ
    assert np.abs(n(tm(t(x[:1, :1]))) - got[:1, :1]).max() > 1e-3


def test_groupnorm_groups_like_flax():
    for groups in (1, 2, 4):
        jn = perturb(nnx.GroupNorm(8, num_groups=groups, rngs=nnx.Rngs(0)))
        tn = load_like(TL.GroupNorm(8, num_groups=groups), jn)
        x = np.random.RandomState(groups).normal(2, 3, (2, 5, 7, 8)).astype(
            np.float32)
        np.testing.assert_allclose(n(tn(t(x))), np.asarray(jn(jnp.asarray(x))),
                                   rtol=0, atol=2e-6)


_H = 64  # hidden width of the layer cases


def _inputs(b=2, pts=256, m=86, k=16, c=8, seed=0):
    """xyzs [b, pts, 3], queries [b, m, 3] (FPS of the xyzs), feats and
    their query rows, knn_idx / mask of the queries among the xyzs."""
    rs = np.random.RandomState(seed)
    xyzs = CLOUDS[:b, :pts]
    idx = np.asarray(JP.farthest_point_sample(jnp.asarray(xyzs), m))
    q = np.take_along_axis(xyzs, idx[..., None], 1)
    feats = rs.normal(size=(b, pts, c)).astype(np.float32)
    _, mask, knn, _ = JL.nearby_distance_sum(jnp.asarray(q),
                                             jnp.asarray(xyzs), k)
    return xyzs, q, feats, np.take_along_axis(feats, idx[..., None], 1), \
        np.asarray(knn), np.asarray(mask)


def _case_transformer():
    x, q, f, qf, knn, mask = _inputs()
    return ((JL.PointTransformerLayer, TL.PointTransformerLayer,
             (8, 8, _H, 1)), (q, x, qf, f, f, knn, mask), 1e-5)


def _case_position():
    x, q, _, _, knn, mask = _inputs()
    return ((JL.PositionEmbeddingLayer, TL.PositionEmbeddingLayer,
             (_H, 8, 1)), (q, x, knn, mask), 1e-5)


def _case_density():
    rs = np.random.RandomState(1)
    dnum = rs.randint(0, 9, (2, 86)).astype(np.float32)
    return ((JL.DensityEmbeddingLayer, TL.DensityEmbeddingLayer, (_H, 8, 1)),
            (dnum,), 1e-5)


def _case_downsample():
    x, _, f, _, _, _ = _inputs()
    return ((JL.DownsampleLayer, TL.DownsampleLayer, (1 / 3, 8, _H, 16, 1)),
            (x, f), 1e-4)


def _case_edgeconv():
    _, _, f, _, _, _ = _inputs()
    return ((JL.EdgeConv, TL.EdgeConv, (8, 16, _H, 16)), (f,), 1e-5)


def _case_subpoint_mlp():
    _, _, f, _, _, _ = _inputs()
    return ((JL.SubPointConv, TL.SubPointConv, (_H, 16, "mlp", 8, 344, 8)),
            (f,), 1e-5)


def _case_subpoint_edge():
    _, _, f, _, _, _ = _inputs()
    return ((JL.SubPointConv, TL.SubPointConv,
             (_H, 16, "edge_conv", 8, 64, 8)), (f,), 1e-5)


def _case_xyzs_upsample():
    x, _, f, _, _, _ = _inputs()
    return ((JL.XyzsUpsampleLayer, TL.XyzsUpsampleLayer,
             (8, _H, 16, "mlp", 8)), (x, f), 5e-5)


def _case_feats_upsample():
    _, _, f, _, _, _ = _inputs()
    return ((JL.FeatsUpsampleLayer, TL.FeatsUpsampleLayer,
             (8, _H, 16, "mlp", 8)), (f,), 1e-5)


def _case_feats_upsample_normal():
    _, _, f, _, _, _ = _inputs()
    return ((JL.FeatsUpsampleLayer, TL.FeatsUpsampleLayer,
             (8, _H, 16, "mlp", 1, True)), (f,), 1e-5)


def _case_upsample():
    x, _, f, _, _, _ = _inputs()
    return ((JL.UpsampleLayer, TL.UpsampleLayer, (8, _H, 16, "mlp", 8)),
            (x, f), 5e-5)


def _case_upsample_num():
    _, _, f, _, _, _ = _inputs()
    return ((JL.UpsampleNumLayer, TL.UpsampleNumLayer, (8, _H, 8)), (f,),
            1e-5)


def _case_refine():
    x, _, f, _, _, _ = _inputs()
    return ((JL.RefineLayer, TL.RefineLayer, (8, _H, 16, "edge_conv")),
            (x, f), 5e-5)


def _case_shared_mlp():
    _, _, f, _, _, _ = _inputs()
    return ((JP.SharedMLP, TP.SharedMLP, ([8, 64, 32, 16],)), (f,), 1e-5)


def _case_set_mlp():
    x, _, _, _, _, _ = _inputs()
    return ((JP.PointNetSetMLP, TP.PointNetSetMLP, ([3, 64, 128],)), (x,),
            1e-5)


def _case_set_abstraction():
    x, _, f, _, _, _ = _inputs()
    return ((JP2.PointNetSetAbstraction, TP2.PointNetSetAbstraction,
             (64, 0.2, 16, 3 + 8, [32, 64])), (x, f), 1e-5)


def _case_set_abstraction_all():
    x, _, f, _, _, _ = _inputs()
    return ((JP2.PointNetSetAbstraction, TP2.PointNetSetAbstraction,
             (None, None, None, 3 + 8, [32, 64], True)), (x, f), 1e-5)


def _case_sfu_set_abstraction():
    x, _, f, _, _, _ = _inputs(c=64)
    return ((JM2.SetAbstraction, TM2.SetAbstraction,
             (64, 0.4, 16, [3 + 64, 128, 128])), (x, f), 1e-5)


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    (jcls, tcls, args), inputs, atol = CASES[case]()
    jm = perturb(jcls(*args, rngs=nnx.Rngs(0)))
    tm = load_like(tcls(*args), jm)
    want = jm(*[jnp.asarray(a) for a in inputs])
    got = tm(*[t(a) for a in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=case)
