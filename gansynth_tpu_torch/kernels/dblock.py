"""K3: the fused stage-6 critic block, its plain version and its launch count.

``fused_dblock`` replaces the TPU kernel
``gansynth_tpu/kernels/pallas_dblock.py:fused_dblock`` (``_dblock_pallas``):
conv3x3 SAME 64->64 + b0 -> lrelu -> conv3x3 SAME 64->C1 + b1 -> lrelu ->
2x2 mean pool, with the two intermediate activations kept on chip. For a
CUDA tensor it launches the CUDA kernel of ``csrc/dblock.cu`` (built by
``nvcc`` on first use): in bf16 both convs on Hopper's tensor cores
(``wgmma``, the input tile and the weights brought in by TMA), in f32 the
FMA units. For a CPU tensor it calls :func:`dblock_plain`, the reference's
``_literal_chain``. There is no fallback from one to the other.

Its backward, like the reference's (``pallas_dblock.py:286-296``),
recomputes the chain from the saved inputs, but writes the adjoints out
in differentiable torch ops (the lrelu masks, the transposed convs,
``conv2d_weight``, the bias sums, the pool's spread) instead of calling
``torch.autograd.grad`` on the recomputed chain: in the critic's real and
fake passes x does not require grad, and WGAN-GP differentiates this
backward once more.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import is_recomputing
from gansynth_tpu_torch.kernels._build import load_library
from gansynth_tpu_torch.utils.device import slope_in

_SYMBOLS = {torch.float32: "dblock_nhwc_f32",
            torch.bfloat16: "dblock_nhwc_bf16"}
C_IN = 64   # the kernel's input and conv0 width (the stage-6 width)


def dblock_eligible(x_shape, c_out0: int, c_out1: int) -> bool:
    """The reference's routing gate (``pallas_dblock.py:302``)."""
    if len(x_shape) != 4:
        return False
    _, h, w, c_in = x_shape
    return c_in == C_IN and c_out0 == C_IN and h % 4 == 0 and w % 16 == 0 \
        and h >= 8


def _lrelu(v: torch.Tensor, slope: float) -> torch.Tensor:
    """The chain's ``where(v >= 0, v, slope * v)``, with the slope in v's
    type as JAX takes it."""
    return torch.where(v >= 0, v, slope_in(v.dtype, slope) * v)


def _pool(v: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of an NCHW tensor (the chain's reshape-mean)."""
    b, c, h, w = v.shape
    return v.reshape(b, c, h // 2, 2, w // 2, 2).mean((3, 5))


def dblock_plain(x, k0, b0, k1, b1, slope: float = 0.2) -> torch.Tensor:
    """``_literal_chain`` in x's type: x [B, H, W, 64] NHWC; k0 [64, 64, 3,
    3] and k1 [C1, 64, 3, 3] OIHW with the eq-LR scale folded in; b0, b1.
    Returns [B, H/2, W/2, C1]."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    a0 = _lrelu(F.conv2d(xc, k0.to(dt), padding=1)
                + b0.to(dt)[:, None, None], slope)
    a1 = _lrelu(F.conv2d(a0, k1.to(dt), padding=1)
                + b1.to(dt)[:, None, None], slope)
    return _pool(a1).permute(0, 2, 3, 1).contiguous()


def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("dblock").lib, _SYMBOLS[dtype])
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, k0, b0, k1, b1, slope: float) -> torch.Tensor:
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"fused_dblock takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_dblock needs a contiguous NHWC input")
    for p in (k0, b0, k1, b1):
        if p.device != x.device:
            raise TypeError("fused_dblock needs its weights on x's device")
    batch, height, width, _ = x.shape
    c1 = k1.shape[0]
    dt = x.dtype
    hwoi0 = k0.to(dt).permute(2, 3, 0, 1).contiguous()
    hwoi1 = k1.to(dt).permute(2, 3, 0, 1).contiguous()
    b0c, b1c = b0.to(dt).contiguous(), b1.to(dt).contiguous()
    y = torch.empty((batch, height // 2, width // 2, c1), dtype=dt,
                    device=x.device)
    fn = _kernel(dt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), hwoi0.data_ptr(), b0c.data_ptr(),
                 hwoi1.data_ptr(), b1c.data_ptr(), y.data_ptr(), batch,
                 height, width, c1, float(slope), stream)
    if err != 0:
        raise RuntimeError(f"dblock kernel launch failed: cudaError {err}")
    if is_recomputing():
        fused_dblock.recompute_launches += 1
    else:
        fused_dblock.launches += 1
    return y


class _FusedDBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k0, b0, k1, b1, slope):
        ctx.save_for_backward(x, k0, b0, k1, b1)
        ctx.slope = slope
        if x.device.type == "cpu":
            return dblock_plain(x, k0, b0, k1, b1, slope)
        if x.device.type != "cuda":
            raise ValueError(f"fused_dblock: unsupported device {x.device}")
        return _launch(x, k0, b0, k1, b1, slope)

    @staticmethod
    def backward(ctx, g):
        x, k0, b0, k1, b1 = ctx.saved_tensors
        slope = ctx.slope
        need = ctx.needs_input_grad
        dt = x.dtype
        xc = x.permute(0, 3, 1, 2)
        k0c, k1c = k0.to(dt), k1.to(dt)
        # Recompute the chain's pre-activations.
        z0 = F.conv2d(xc, k0c, padding=1) + b0.to(dt)[:, None, None]
        a0 = _lrelu(z0, slope)
        z1 = F.conv2d(a0, k1c, padding=1) + b1.to(dt)[:, None, None]
        # Adjoints: the pool spreads g / 4 over its window, each lrelu
        # scales by its mask, each conv's input adjoint is the transposed
        # conv and its weight adjoint conv2d_weight.
        g_a1 = (g.to(dt).permute(0, 3, 1, 2) * 0.25).repeat_interleave(
            2, dim=2).repeat_interleave(2, dim=3)
        s = slope_in(dt, slope)
        g_z1 = torch.where(z1 >= 0, g_a1, s * g_a1)
        g_a0 = F.conv_transpose2d(g_z1, k1c, padding=1)
        g_z0 = torch.where(z0 >= 0, g_a0, s * g_a0)
        grads = [None] * 6
        if need[0]:
            grads[0] = F.conv_transpose2d(g_z0, k0c, padding=1).permute(
                0, 2, 3, 1).to(x.dtype)
        if need[1]:
            grads[1] = torch.nn.grad.conv2d_weight(
                xc, k0.shape, g_z0, padding=1).to(k0.dtype)
        if need[2]:
            grads[2] = g_z0.sum((0, 2, 3)).to(b0.dtype)
        if need[3]:
            grads[3] = torch.nn.grad.conv2d_weight(
                a0, k1.shape, g_z1, padding=1).to(k1.dtype)
        if need[4]:
            grads[4] = g_z1.sum((0, 2, 3)).to(b1.dtype)
        return tuple(grads)


def fused_dblock(x, k0, b0, k1, b1, slope: float = 0.2) -> torch.Tensor:
    """conv3x3 -> +b0 -> lrelu -> conv3x3 -> +b1 -> lrelu -> 2x2 mean pool.

    ``x`` [B, H, W, 64] NHWC contiguous (f32 or bf16); ``k0`` [64, 64, 3,
    3], ``k1`` [C1, 64, 3, 3] OIHW with the eq-LR scale folded in, ``b0``,
    ``b1`` (any float type; cast to x's type, as the chain does). Returns
    [B, H/2, W/2, C1] in x's type. Launches the CUDA kernel for a CUDA
    tensor (counted in ``fused_dblock.launches``, or in
    ``fused_dblock.recompute_launches`` in a rematerialised forward,
    ``ModelConfig.remat``); takes
    :func:`dblock_plain` for a CPU tensor. Differentiable to any order.
    """
    if (x.ndim != 4 or x.shape[-1] != C_IN or tuple(k0.shape) !=
            (C_IN, C_IN, 3, 3) or tuple(k1.shape[1:]) != (C_IN, 3, 3)
            or x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"fused_dblock: x {tuple(x.shape)}, k0 "
                         f"{tuple(k0.shape)}, k1 {tuple(k1.shape)} do not fit")
    return _FusedDBlock.apply(x, k0, b0, k1, b1, slope)


fused_dblock.launches = 0
fused_dblock.recompute_launches = 0
