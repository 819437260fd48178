"""Point-cloud layers (port of flashgmm_tpu/layers/pointcloud)."""

from .hrtzxf2022 import (
    DensityEmbeddingLayer,
    DownsampleLayer,
    EdgeConv,
    FeatsUpsampleLayer,
    GroupNorm,
    PointTransformerLayer,
    PositionEmbeddingLayer,
    RefineLayer,
    SubPointConv,
    UpsampleLayer,
    UpsampleNumLayer,
    XyzsUpsampleLayer,
    icosphere_directions,
    index_points,
    knn_indices,
    nearby_distance_sum,
    select_xyzs_and_feats,
)
from .pointnet import (PointNetSetMLP, SharedMLP, f32_einsum,
                       farthest_point_sample)
from .pointnet2 import (
    PointNetSetAbstraction,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    square_distance,
)

__all__ = [
    "SharedMLP", "PointNetSetMLP", "farthest_point_sample", "f32_einsum",
    "DensityEmbeddingLayer", "DownsampleLayer", "EdgeConv",
    "FeatsUpsampleLayer", "GroupNorm", "PointTransformerLayer",
    "PositionEmbeddingLayer", "RefineLayer", "SubPointConv", "UpsampleLayer",
    "UpsampleNumLayer", "XyzsUpsampleLayer", "icosphere_directions",
    "index_points", "knn_indices", "nearby_distance_sum",
    "select_xyzs_and_feats",
    "PointNetSetAbstraction", "query_ball_point", "sample_and_group",
    "sample_and_group_all", "square_distance",
]
