from .base import (CompressionModel, SimpleVAECompressionModel,
                   get_scale_table)
from .chandelier import Elic2022Chandelier
from .ckbd_gmm import Cheng2020AnchorCheckerboardGMMv2
from .elic_gmm import Elic2022GMM
from .google import (FactorizedPrior, FactorizedPriorReLU,
                     JointAutoregressiveHierarchicalPriors,
                     MeanScaleHyperprior, ScaleHyperprior)
from .pointcloud import (DensityPreservingReconstructionPccModel,
                         FoldingPccModel, PointNet2ReconstructionPccModel,
                         PointNetReconstructionPccModel)
from .sensetime import Cheng2020AnchorCheckerboard, Elic2022Official
from .sigmoidkernel import SigmoidCDFCompressor
from .vbr import (JointAutoregressiveHierarchicalPriorsVbr,
                  MeanScaleHyperpriorVbr, ScaleHyperpriorVbr)
from .video import ScaleSpaceFlow
from .waseda import Cheng2020Anchor, Cheng2020Attention

__all__ = ["CompressionModel", "SimpleVAECompressionModel",
           "Cheng2020Anchor", "Cheng2020AnchorCheckerboard",
           "Cheng2020AnchorCheckerboardGMMv2", "Cheng2020Attention",
           "DensityPreservingReconstructionPccModel", "FoldingPccModel",
           "Elic2022Chandelier", "Elic2022GMM", "Elic2022Official",
           "FactorizedPrior", "FactorizedPriorReLU",
           "JointAutoregressiveHierarchicalPriors",
           "JointAutoregressiveHierarchicalPriorsVbr", "MeanScaleHyperprior",
           "MeanScaleHyperpriorVbr", "PointNet2ReconstructionPccModel",
           "PointNetReconstructionPccModel", "ScaleHyperprior",
           "ScaleHyperpriorVbr",
           "ScaleSpaceFlow", "SigmoidCDFCompressor", "get_scale_table"]
