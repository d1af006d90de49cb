"""K2: the 3x3 trunk convolution and its plain version.

``conv3x3_same`` replaces the TPU kernel
``gansynth_tpu/kernels/pallas_conv.py:conv3x3_same`` (``_conv3x3_pallas``
and its C_in = 64 pixel-paired variant): an NHWC stride-1 SAME 3x3 conv
with f32 accumulation and the output in x's type. For a CUDA tensor it
launches the CUDA kernel of ``csrc/conv3x3.cu`` (built by ``nvcc`` on first
use): in bf16 an implicit GEMM on Hopper's tensor cores (TMA loads into an
mbarrier ring, ``wgmma``), which takes channel counts that are multiples
of 8 (TMA's 16-byte strides); in f32 the FMA units, any channel count. For
a CPU tensor it calls :func:`conv3x3_plain`. There is no fallback from one
to the other. Both sit behind the operator ``gansynth_torch::conv3x3``, so
a ``torch.export`` trace of a model that routes a conv here keeps K2 as one
node of its program (``synth/export.py``).

It is differentiable to any order, like the reference's custom VJP
(``pallas_conv.py:261-290``): the input gradient is another
``conv3x3_same`` call with the kernel flipped in space and transposed in
io, and the weight gradient is a plain convolution over the batch axis
(``torch.nn.grad.conv2d_weight``), itself differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import count
from gansynth_tpu_torch.kernels._build import I32, PTR, launch, symbol

_SYMBOLS = {torch.float32: "conv3x3_nhwc_f32",
            torch.bfloat16: "conv3x3_nhwc_bf16"}


def conv3x3_eligible(x_shape, kernel_shape) -> bool:
    """The reference's routing gate (``pallas_conv.py:293``), kept so that
    both packages run their kernel at the same layers. ``kernel_shape`` is
    HWIO, as in the reference."""
    if len(x_shape) != 4 or tuple(kernel_shape[:2]) != (3, 3):
        return False
    _, h, w, c_in = x_shape
    return c_in % 128 == 0 and c_in <= 512 and w % 16 == 0 and w >= 128 \
        and h >= 2


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The same function with ``F.conv2d``: x [B, H, W, C_in] NHWC, weight
    [C_out, C_in, 3, 3] OIHW in x's type -> [B, H, W, C_out]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _kernel(dtype: torch.dtype):
    return symbol("conv3x3", _SYMBOLS[dtype], [PTR] * 3 + [I32] * 5 + [PTR])


def _launch(x: torch.Tensor, weight: torch.Tensor, role: str) -> torch.Tensor:
    """One launch of the CUDA kernel; counts it under ``role``."""
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"conv3x3_same takes float32 or bfloat16, got {x.dtype}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise TypeError("conv3x3_same needs the weight in x's type and device")
    if not x.is_contiguous():
        raise ValueError("conv3x3_same needs a contiguous NHWC input")
    batch, height, width, c_in = x.shape
    c_out = weight.shape[0]
    if x.dtype == torch.bfloat16 and (c_in % 8 or c_out % 8):
        raise ValueError(f"conv3x3_same in bfloat16 needs C_in and C_out "
                         f"multiples of 8, got {c_in} -> {c_out}")
    k_hwoi = weight.permute(2, 3, 0, 1).contiguous()
    y = torch.empty((batch, height, width, c_out), dtype=x.dtype,
                    device=x.device)
    launch("conv3x3 kernel", _kernel(x.dtype), x.device, x, k_hwoi, y, batch,
           height, width, c_in, c_out)
    count("conv3x3", role, batch, height, width, c_in, c_out)
    return y


def _conv_cpu(x: torch.Tensor, weight: torch.Tensor, role: str) -> torch.Tensor:
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    return conv3x3_plain(x, weight)


def _conv_fake(x, weight, role):
    return x.new_empty((*x.shape[:3], weight.shape[0]))


# K2 as an operator of its own, kept as one node by a torch.export trace.
_conv_op = torch.library.custom_op("gansynth_torch::conv3x3", _conv_cpu,
                                   mutates_args=())
_conv_op.register_kernel("cuda")(_launch)
_conv_op.register_fake(_conv_fake)
_EAGER = {"cpu": _conv_cpu, "cuda": _launch}


class _Conv3x3(torch.autograd.Function):
    """x NHWC, weight OIHW (in x's type) -> NHWC. ``role`` labels the launch
    count: ``"forward"`` for the model's call, ``"input_grad"`` for every
    call that a backward pass makes."""

    @staticmethod
    def forward(ctx, x, weight, role):
        ctx.save_for_backward(x, weight)
        if type(x) is torch.Tensor:   # eager: no dispatcher, as for K1
            return _EAGER.get(x.device.type, _conv_cpu)(x, weight, role)
        return torch.ops.gansynth_torch.conv3x3(x, weight, role)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            # The adjoint of a SAME 3x3 conv: the same conv with the kernel
            # flipped in space and transposed in io (pallas_conv.py:273-277).
            w_adj = weight.flip(-2, -1).transpose(0, 1).to(g.dtype)
            dx = _Conv3x3.apply(g, w_adj, "input_grad").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), weight.shape,
                g.to(x.dtype).permute(0, 3, 1, 2), padding=1,
            ).to(weight.dtype)
        return dx, dw, None


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """NHWC stride-1 SAME 3x3 conv, f32 accumulation, output in x's type.

    ``x`` [B, H, W, C_in] contiguous, ``weight`` [C_out, C_in, 3, 3] in x's
    type. Launches the CUDA kernel for a CUDA tensor (``kernels.count``:
    the role ``"forward"``, ``"input_grad"`` for the launches of its
    backward passes, ``"recompute"`` for those of a rematerialised
    forward, ``ModelConfig.remat``); takes :func:`conv3x3_plain` for a CPU
    tensor. Differentiable to any order.
    """
    if x.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"conv3x3_same: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} do not fit")
    return _Conv3x3.apply(x, weight, "forward")
