from .image import ImageFolder, load_image, save_image
from .loader import BatchLoader
from .synthetic import dead_leaves, textured_leaves
from .utils import NdArrayDataset

__all__ = ["BatchLoader", "ImageFolder", "NdArrayDataset", "dead_leaves",
           "load_image", "save_image", "textured_leaves"]
