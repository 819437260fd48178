"""Entropy-coding math of the port: GMM CDF rows, the interleaved rANS coder
(plain versions and CUDA kernels) and the PMF quantizer."""
