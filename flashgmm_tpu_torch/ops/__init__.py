from .bound_ops import lower_bound
from .ops import compute_padding, pad_image, quantize_ste, unpad_image
from .parametrizers import NonNegativeParametrizer

__all__ = [
    "lower_bound",
    "quantize_ste",
    "compute_padding",
    "pad_image",
    "unpad_image",
    "NonNegativeParametrizer",
]
