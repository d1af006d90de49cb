"""The H100's published peaks and the roofline bound.

Copied from ``chip_smoke.py`` at commit 267e540 (``F32_PEAK_FLOPS``,
``BF16_PEAK_FLOPS``, ``HBM_BYTES_PER_S``, ``bound``, ``synthesis_bound``).
NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at the full
700 W power limit.
"""

from __future__ import annotations

from typing import Tuple

F32_PEAK_FLOPS = 67e12     # float32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12   # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # HBM3


def bound(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """``(seconds, bound_by)``: the larger of operations over the peak
    rate and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def synthesis_bound(batch: int, frames: int, mel: int, freq: int,
                    nnz: int) -> Tuple[float, str]:
    """K1's least time: ``(seconds, bound_by)``. The mel pseudo-inverse is
    banded (``nnz`` nonzeros), so the function needs one FMA per nonzero
    and row in each of its two products, reads the image and the
    nonzeros (an f32 value and an int32 index each) and writes the two
    spectra."""
    rows = batch * frames
    flops = 4.0 * rows * nnz
    nbytes = 4.0 * (rows * mel * 2 + 2 * rows * freq) + 8.0 * nnz
    return bound(flops, nbytes, F32_PEAK_FLOPS)
