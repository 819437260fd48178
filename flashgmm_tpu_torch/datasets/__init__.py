from .image import ImageFolder, load_image, save_image
from .loader import BatchLoader
from .pointcloud import (ModelNetDataset, PointCloudFolder, S3disDataset,
                         SemanticKittiDataset, ShapeNetCorePartDataset,
                         load_point_cloud)
from .rawvideo import RawVideoSequence, VideoFormat, get_raw_video_file_info
from .synthetic import dead_leaves, textured_leaves
from .utils import (CacheDataset, NdArrayDataset, PreGeneratedMemmapDataset,
                    StackDataset)
from .video import VideoFolder, Vimeo90kDataset

__all__ = ["BatchLoader", "CacheDataset", "ImageFolder", "ModelNetDataset",
           "NdArrayDataset", "PointCloudFolder", "PreGeneratedMemmapDataset",
           "RawVideoSequence", "S3disDataset", "SemanticKittiDataset",
           "ShapeNetCorePartDataset", "StackDataset", "VideoFolder",
           "VideoFormat", "Vimeo90kDataset", "dead_leaves",
           "get_raw_video_file_info", "load_image", "load_point_cloud",
           "save_image", "textured_leaves"]
