"""Entropy-coding math of the port: GMM CDF rows, the interleaved rANS coder
(plain versions and CUDA kernels), the PMF quantizer, and the host rANS
coder of the reference format (``cext``, the port's build of
``csrc/rans.cpp``) behind ``RansEncoder`` / ``RansDecoder`` (port of
flashgmm_tpu/ans/__init__.py:25-58, without its numpy fallback: the host
coder must build, or every call raises)."""

from . import cext
from .pmf_to_cdf import pmf_to_quantized_cdf

__all__ = ["RansDecoder", "RansEncoder", "pmf_to_quantized_cdf"]


class RansEncoder:
    """Encoders of the host coder over numpy buffers."""

    def encode_with_indexes(self, symbols, indexes, cdfs, cdfs_sizes, offsets):
        return cext.encode_with_indexes(symbols, indexes, cdfs, cdfs_sizes,
                                        offsets)

    def encode_rows(self, values, rows, lo):
        return cext.encode_rows(values, rows, lo)

    def encode_gmm_host(self, values, scales, means, weights, approx_mode=0):
        return cext.encode_gmm_host(values, scales, means, weights,
                                    approx_mode)


class RansDecoder:
    """Decoders of the host coder over numpy buffers."""

    def decode_with_indexes(self, encoded, indexes, cdfs, cdfs_sizes, offsets):
        return cext.decode_with_indexes(encoded, indexes, cdfs, cdfs_sizes,
                                        offsets)

    def decode_rows(self, encoded, rows, lo):
        return cext.decode_rows(encoded, rows, lo)

    def decode_gmm_host(self, encoded, scales, means, weights, max_bs_value,
                        approx_mode=0):
        return cext.decode_gmm_host(encoded, scales, means, weights,
                                    max_bs_value, approx_mode)
