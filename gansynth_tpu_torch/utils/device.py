"""Device selection, matmul precision and the card's identity line."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is not there raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def set_precision() -> None:
    """Full f32 in matmuls and convolutions (no TF32).

    cuDNN's default is TF32 for f32 convolutions; TF32 keeps ~3 decimal
    digits, far outside the parity tolerances against the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_info() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def dtype_of(name: Optional[str]) -> torch.dtype:
    """Config dtype name (``"float32"``, ``"bfloat16"``) -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]


def slope_in(dtype: torch.dtype, slope: float) -> float:
    """``slope`` rounded to ``dtype``, as a Python float.

    The reference multiplies an activation by a Python-float slope, which
    JAX treats as weakly typed: it takes the activation's type, so in
    bfloat16 the LeakyReLU slope 0.2 is 0.2001953125. PyTorch keeps a
    Python scalar in float32 inside the op, so the port rounds the slope
    itself.
    """
    return float(torch.tensor(slope, dtype=dtype))
