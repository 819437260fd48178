from .synthetic import dead_leaves, textured_leaves

__all__ = ["dead_leaves", "textured_leaves"]
