from .google import ScaleSpaceFlow

__all__ = ["ScaleSpaceFlow"]
