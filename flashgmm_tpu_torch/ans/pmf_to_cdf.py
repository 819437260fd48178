"""Quantize a float PMF to an integer CDF summing to 2**precision.

The port's own copy of flashgmm_tpu/ans/pmf_to_cdf.py (pure numpy; a copy,
because importing anything under flashgmm_tpu imports JAX). A bit-exact port
of CompressAI's C++ quantizer (cpp_exts/ops/ops.cpp:40-109): round to integer
frequencies, rescale by exact integer division, prefix-sum, then steal
frequency from the richest-smallest bin to remove zero-width bins.
Pure integer math after the initial float round, so results match the C++
implementation exactly (bitstream compatibility depends on this).
"""

import numpy as np


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    pmf = np.asarray(pmf, dtype=np.float32)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError(
            f"Invalid `pmf`, non-finite or negative element found: {pmf}"
        )

    # C++ std::round: half away from zero. np.round is banker's rounding,
    # so emulate round-half-up for non-negative entries.
    scaled = pmf.astype(np.float64) * (1 << precision)
    freqs = np.floor(scaled + 0.5).astype(np.uint64)

    cdf = np.zeros(pmf.shape[0] + 1, dtype=np.uint64)
    cdf[1:] = freqs

    total = int(cdf.sum())
    if total == 0:
        raise ValueError(
            "Invalid `pmf`: at least one element must have a non-zero probability."
        )

    cdf = ((1 << precision) * cdf) // total  # exact integer rescale
    cdf = np.cumsum(cdf, dtype=np.uint64)
    cdf[-1] = 1 << precision

    cdf = cdf.astype(np.int64)
    n = cdf.shape[0]
    big = np.iinfo(np.int64).max
    for i in range(n - 1):
        if cdf[i] == cdf[i + 1]:
            # steal from the smallest bin with freq > 1, the first of equals
            # (the C++ loop's strict "<"): one vectorised argmin
            freq = np.diff(cdf)
            best_steal = int(np.argmin(np.where(freq > 1, freq, big)))
            assert freq[best_steal] > 1
            if best_steal < i:
                cdf[best_steal + 1 : i + 1] -= 1
            else:
                cdf[i + 1 : best_steal + 1] += 1

    assert cdf[0] == 0
    assert cdf[-1] == (1 << precision)
    assert np.all(cdf[1:] > cdf[:-1])
    return cdf.astype(np.int32)
