from .image import ImageFolder, load_image, save_image
from .loader import BatchLoader
from .rawvideo import RawVideoSequence, VideoFormat, get_raw_video_file_info
from .synthetic import dead_leaves, textured_leaves
from .utils import NdArrayDataset
from .video import VideoFolder, Vimeo90kDataset

__all__ = ["BatchLoader", "ImageFolder", "NdArrayDataset", "RawVideoSequence",
           "VideoFolder", "VideoFormat", "Vimeo90kDataset", "dead_leaves",
           "get_raw_video_file_info", "load_image", "save_image",
           "textured_leaves"]
