from .entropy_models import EntropyBottleneck

__all__ = ["EntropyBottleneck"]
