"""K2's work at one launch's shape, for ``train.k2_roofline``."""

from __future__ import annotations

from typing import Tuple


def conv3x3_work(b: int, h: int, w: int, c_in: int,
                 c_out: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one K2 launch, an NHWC SAME 3x3 conv of
    ``[b, h, w, c_in]`` to ``c_out`` channels: 9 multiply-adds per input
    channel, output channel and pixel; bf16 input, weights and output,
    each read or written once."""
    flops = 2.0 * 9 * b * h * w * c_in * c_out
    nbytes = 2.0 * (b * h * w * c_in + 9 * c_in * c_out + b * h * w * c_out)
    return flops, nbytes
