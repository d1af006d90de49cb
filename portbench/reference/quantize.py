"""Lower precisions for the reference's conv and dense operands, in the
forward pass and in the backward pass, as an autograd function.

``fp8`` is the control, the step below the configuration's bfloat16: the
forward operands rounded to float8 e4m3 and the gradients flowing back
into them to float8 e5m2, each with one scale per tensor (its largest
magnitude mapped to the format's largest finite value), as an fp8
training recipe runs its GEMMs. ``bf16`` rounds both directions to
bfloat16 without scaling: the reference computed in the configuration's
own precision, a second witness beside the program.
"""

from __future__ import annotations

import torch

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    with torch.no_grad():
        if dtype in _MAX:
            scale = _MAX[dtype] / x.abs().amax().clamp_min(1e-30)
            return (x * scale).to(dtype).to(x.dtype) / scale
        return x.to(dtype).to(x.dtype)


_ROUNDINGS = {}


def _rounding(forward: torch.dtype, backward: torch.dtype):
    """Rounds to ``forward``; the gradient to ``backward`` (and a second
    order's to ``forward`` again, through the same function)."""
    key = (forward, backward)
    if key not in _ROUNDINGS:
        class Round(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return _round(x, forward)

            @staticmethod
            def backward(ctx, g):
                return _rounding(backward, forward)(g)

        _ROUNDINGS[key] = Round.apply
    return _ROUNDINGS[key]


fp8 = _rounding(torch.float8_e4m3fn, torch.float8_e5m2)
bf16 = _rounding(torch.bfloat16, torch.bfloat16)
