"""K4: the generator's per-conv epilogue, bias -> LeakyReLU -> pixel norm,
its plain version and its first-order backward.

``gen_epilogue(z, bias, slope, eps)`` is ``pixel_norm(leaky_relu(z +
bias.to(z.dtype), slope), eps)`` (``models/layers.py``) for the output z
of a generator block's conv before its bias, [B, H, W, C] NHWC, with the
chain's roundings: the bias added in z's type, the LeakyReLU's slope in
z's type (``utils.device.slope_in``), the pixel norm's sum over C, rsqrt
and multiply in float32, the result in z's type. It replaces no TPU
kernel: XLA fuses the JAX package's epilogue
(``gansynth_tpu/models/generator.py``) by itself, where PyTorch runs the
chain as some twenty passes through device memory and keeps its float32
intermediates for the backward pass.

For a CUDA tensor it launches the kernels of ``csrc/gen_epilogue.cu``
(built by ``nvcc`` on first use; float32 or bf16, C a power of two times
the 16-byte vector and at most 64 vectors). For a CPU tensor it is the
plain chain itself, with autograd's gradients. There is no fallback from
one to the other. Both sit behind the operator
``gansynth_torch::gen_epilogue``, so a ``torch.export`` trace keeps K4 as
one node of its program (``synth/export.py``).

The backward is first order only (``once_differentiable``): nothing
differentiates the generator twice (the critic update runs it under
``no_grad``, the generator update takes one gradient). On a card it is
one launch, which recomputes the activation from the saved z and bias,
takes the pixel norm's adjoint per pixel in float32 (``s g - a s^3
mean_c(g a)``), rounds it to z's type, applies the LeakyReLU's mask and
writes dz, with float32 partial sums of the bias gradient per block, and
a second small launch that adds the partials in a fixed order: no
atomics, so a CUDA graph's replay gives the eager run's bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gansynth_tpu_torch.kernels import count
from gansynth_tpu_torch.kernels._build import (
    F32,
    I32,
    I64,
    PTR,
    launch,
    symbol,
)
from gansynth_tpu_torch.utils.device import slope_in

_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def gen_epilogue_plain(z: torch.Tensor, bias: torch.Tensor,
                       slope: float = 0.2, eps: float = 1e-8) -> torch.Tensor:
    """The chain K4 replaces, op for op: ``models/layers.py``'s
    ``pixel_norm(leaky_relu(z + bias))``."""
    a = F.leaky_relu(z + bias.to(z.dtype), slope_in(z.dtype, slope))
    a32 = a.float()
    s = torch.rsqrt(torch.mean(torch.square(a32), dim=-1, keepdim=True) + eps)
    return (a32 * s).to(z.dtype)


def gen_epilogue_backward_plain(z: torch.Tensor, bias: torch.Tensor,
                                g: torch.Tensor, slope: float = 0.2,
                                eps: float = 1e-8):
    """``(dz, dbias)`` of the chain for the gradient ``g`` of its output,
    in the backward kernel's arithmetic: the activation recomputed, the
    pixel norm's adjoint in float32 rounded to z's type, the LeakyReLU's
    mask, the bias gradient summed in float32 and rounded to z's type."""
    dt = z.dtype
    v = z + bias.to(dt)
    a = F.leaky_relu(v, slope_in(dt, slope)).float()
    s = torch.rsqrt(torch.mean(torch.square(a), dim=-1, keepdim=True) + eps)
    gf = g.float()
    coef = s * s * s * torch.mean(gf * a, dim=-1, keepdim=True)
    dx = (s * gf - a * coef).to(dt)
    dz = torch.where(v > 0, dx, dx * slope_in(dt, slope))
    dbias = dz.float().sum(dim=tuple(range(z.ndim - 1))).to(dt)
    return dz, dbias.to(bias.dtype)


def _kernel(direction: str, dtype: torch.dtype):
    tensors = 3 if direction == "forward" else 6
    return symbol("gen_epilogue", f"gen_epilogue_{direction}_{_TYPES[dtype]}",
                  [PTR] * tensors + [I64, I32, F32, F32, PTR])


def _blocks(rows: int, c: int, dtype: torch.dtype) -> int:
    """The backward's blocks: its rows of float32 partial sums."""
    fn = symbol("gen_epilogue", "gen_epilogue_blocks", [I64, I32, I32])
    return fn(rows, c, torch.finfo(dtype).bits // 8)


def _on_card(name: str, z: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"gen_epilogue: {name} runs on a card, not on "
                         f"{z.device}")


def _check(name: str, *tensors: torch.Tensor) -> None:
    z = tensors[0]
    if z.dtype not in _TYPES:
        raise TypeError(f"gen_epilogue takes float32 or bfloat16, got "
                        f"{z.dtype}")
    vec = 16 // z.element_size()
    c = z.shape[-1]
    if c < vec or c % vec or (c // vec) & (c // vec - 1) or c // vec > 64:
        raise ValueError(f"gen_epilogue in {z.dtype} takes C a power of two "
                         f"times {vec} up to {64 * vec}, got {c}")
    for t in tensors:
        if t.dtype != z.dtype or t.device != z.device:
            raise TypeError(f"gen_epilogue: {name} needs its tensors in z's "
                            "type and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"gen_epilogue: {name} needs contiguous, "
                             "16-byte aligned NHWC tensors")


def _forward_cuda(z: torch.Tensor, bias: torch.Tensor, slope: float,
                  eps: float) -> torch.Tensor:
    _on_card("the forward", z)
    _check("the forward", z)
    b = bias.to(device=z.device, dtype=torch.float32)
    y = torch.empty_like(z)
    c = z.shape[-1]
    launch("gen_epilogue forward", _kernel("forward", z.dtype), z.device, z,
           b, y, z.numel() // c, c, slope_in(z.dtype, slope), eps)
    count("gen_epilogue", "forward", *z.shape)
    return y


def _backward_cuda(z: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                   slope: float, eps: float, bias_grad: bool):
    _on_card("the backward", z)
    _check("the backward", z, g)
    b = bias.to(device=z.device, dtype=torch.float32)
    dz = torch.empty_like(z)
    c = z.shape[-1]
    rows = z.numel() // c
    partials = dbias = None
    if bias_grad:
        partials = torch.empty((max(_blocks(rows, c, z.dtype), 1), c),
                               dtype=torch.float32, device=z.device)
        dbias = torch.empty(c, dtype=torch.float32, device=z.device)
    launch("gen_epilogue backward", _kernel("backward", z.dtype), z.device,
           z, b, g, dz, partials, dbias, rows, c, slope_in(z.dtype, slope),
           eps)
    count("gen_epilogue", "backward", *z.shape)
    return dz, None if dbias is None else dbias.to(bias.dtype)


def _forward_cpu(z: torch.Tensor, bias: torch.Tensor, slope: float,
                 eps: float) -> torch.Tensor:
    if z.device.type != "cpu":
        raise ValueError(f"gen_epilogue: unsupported device {z.device}")
    return gen_epilogue_plain(z, bias, slope, eps)


def _forward_fake(z, bias, slope, eps):
    return torch.empty_like(z)


# K4 as an operator of its own, kept as one node by a torch.export trace.
_op = torch.library.custom_op("gansynth_torch::gen_epilogue", _forward_cpu,
                              mutates_args=())
_op.register_kernel("cuda")(_forward_cuda)
_op.register_fake(_forward_fake)


class _GenEpilogue(torch.autograd.Function):
    """The kernels with their first-order backward; ``gen_epilogue`` sends
    every plain CPU tensor to the chain instead."""

    @staticmethod
    def forward(ctx, z, bias, slope, eps):
        ctx.save_for_backward(z, bias)
        ctx.slope, ctx.eps = slope, eps
        if type(z) is torch.Tensor:   # eager: no dispatcher, as for K2
            return _forward_cuda(z, bias, slope, eps)
        return torch.ops.gansynth_torch.gen_epilogue(z, bias, slope, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        z, bias = ctx.saved_tensors
        dz, dbias = _backward_cuda(z, bias, g, ctx.slope, ctx.eps,
                                   ctx.needs_input_grad[1])
        return dz, dbias, None, None


def gen_epilogue(z: torch.Tensor, bias: torch.Tensor, slope: float = 0.2,
                 eps: float = 1e-8) -> torch.Tensor:
    """``pixel_norm(leaky_relu(z + bias.to(z.dtype), slope), eps)``.

    ``z`` [B, H, W, C] NHWC (float32 or bf16; on a card contiguous and
    16-byte aligned), ``bias`` [C] (any float type). On a CPU tensor the
    plain chain, differentiable to any order; on a CUDA tensor the
    kernels, counted by ``kernels.count`` in the roles ``"forward"`` (a
    rematerialised forward, ``ModelConfig.remat``, in ``"recompute"``)
    and ``"backward"``; differentiable once.
    """
    if z.ndim != 4 or tuple(bias.shape) != (z.shape[-1],):
        raise ValueError(f"gen_epilogue: z {tuple(z.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit")
    if type(z) is torch.Tensor and z.device.type == "cpu":
        return gen_epilogue_plain(z, bias, slope, eps)
    return _GenEpilogue.apply(z, bias, slope, eps)
