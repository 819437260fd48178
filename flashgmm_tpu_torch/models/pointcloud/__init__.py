"""Point-cloud codecs (port of flashgmm_tpu/models/pointcloud)."""

from .hrtzxf2022 import (DensityPreservingReconstructionPccModel,
                         FoldingDecoder, FoldingPccModel, Hrtzxf2022PccModel,
                         XyzsLatentCodec)
from .sfu_pointnet import PointNetReconstructionPccModel
from .sfu_pointnet2 import (PointNet2ReconstructionPccModel, SetAbstraction,
                            ball_group)

__all__ = ["DensityPreservingReconstructionPccModel", "FoldingDecoder",
           "FoldingPccModel", "Hrtzxf2022PccModel",
           "PointNet2ReconstructionPccModel",
           "PointNetReconstructionPccModel", "SetAbstraction", "XyzsLatentCodec",
           "ball_group"]
