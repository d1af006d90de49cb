"""K4's least bytes at one launch's shape, for ``train.gen_epilogue_roofline``.

K4 is the generator's per-conv epilogue, bias -> LeakyReLU -> pixel norm
(``gansynth_tpu_torch/kernels/csrc/gen_epilogue.cu``), on z [B, H, W, C]
in bf16. Each tensor is read or written once:

- a forward (or a rematerialised one, ``recompute``) reads z and writes
  y, 2 bytes an element each, and reads the bias: ``2 (2 BHWC) + 2 C``;
- a backward reads z and g, writes dz, reads the bias and writes its
  gradient: ``2 (3 BHWC) + 2 (2 C)``, plus its float32 partial sums of
  the bias gradient, one row of C a block of the kernel's grid, written
  once and read once.

The grid follows the kernel's launch shape: ``min(32, C / 8)`` threads a
row, 256 threads a block, 4 rows a thread at once, at most 528 blocks.
"""

from __future__ import annotations

THREADS, UNROLL, MAX_BLOCKS = 256, 4, 528   # csrc/gen_epilogue.cu


def partial_rows(rows: int, c: int) -> int:
    """Blocks of the backward's grid for ``rows`` rows of C channels in
    bf16: its rows of partial sums."""
    chunk = THREADS // min(32, c // 8) * UNROLL
    return min(-(-rows // chunk), MAX_BLOCKS)


def epilogue_bytes(role: str, b: int, h: int, w: int, c: int) -> float:
    """The least bytes of one K4 launch under ``role`` (``"forward"``,
    ``"recompute"`` or ``"backward"``) at z [b, h, w, c] in bf16."""
    n = b * h * w * c
    if role in ("forward", "recompute"):
        return 2.0 * (2 * n) + 2 * c
    if role == "backward":
        return 2.0 * (3 * n) + 2 * (2 * c) + 2 * 4.0 * partial_rows(
            b * h * w, c) * c
    raise KeyError(role)
