"""K6: the weight gradient of WaveGAN's "SAME" stride-4, kernel-25 1-D
convolution, and its plain version.

``conv1d_wgrad(x, gy, role)`` is ``dw[co, ci, k] = sum_{b, t} gy[b, co, 0,
t] * x_pad[b, ci, 0, 4 t + k]`` for x [B, C_in, 1, 4L] and gy [B, C_out,
1, L], x_pad x with 10 zeros before and 11 after its length (TF's "SAME"
padding, ``models/wavegan.py``): the weight gradient of ``same_conv``,
[C_out, C_in, 25] in x's type. The training step asks for it in two
places (``models/wavegan.py``'s three autograd functions): a conv's own
weight gradient (``role`` ``"conv"``), and the weight term of its input
gradient's gradient, which the penalty's second order and the
generator's transposed convs need (``"transpose"``). It replaces no TPU
kernel (the JAX package has no WaveGAN); on an H100 it takes the place of
cuDNN's backward-filter and of the stride-1, dilation-4 convolution that
PyTorch's double backward runs for the second term, both without tensor
cores.

The stride folds into the channels: x is xv [B, L, 4 C_in] in its
channels-last memory, tap k with k + 2 = 4 j + p reads row t + j - 3 of
xv at channel p C_in + ci, and dw is seven products ``gy^T xv`` over the
B L rows, one a row offset j - 3 (:func:`conv1d_wgrad_plain` writes them
out; ``csrc/conv1d_wgrad.cu`` has the design).

Which implementation runs is the tensors' to say:

- bf16 card tensors at widths that :func:`widths_fit`: K6,
  ``csrc/conv1d_wgrad.cu`` (built by ``nvcc`` on first use), the call
  filed with ``kernels.count`` under ``("conv1d_wgrad", role, B, L, C_in,
  C_out)``, L the conv's output length;
- float32 card tensors (``compute_dtype`` float32, as the public code
  trains): cuDNN's weight gradient of the padded conv, the call every
  weight gradient made before K6 (:func:`conv1d_wgrad_cudnn`; not
  counted, K6 has no float32 form);
- CPU tensors: the plain version, float32 sums (float64 for float64
  tensors) rounded once to x's type, which is how the CPU tests run the
  same route;
- any other card call raises: a bf16 width K6 does not take is a fault
  to see, not a slow path to take unseen.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import count
from gansynth_tpu_torch.kernels._build import I32, PTR, launch, symbol

KERNEL, STRIDE = 25, 4
LEFT = (KERNEL - STRIDE) // 2     # the SAME pad: 10 left, 11 right
PAST = -(-LEFT // STRIDE)         # rows before t that tap 0 reads: 3
FIRST = STRIDE * PAST - LEFT      # slot 4 j + p of tap k = 0: 2
TAPS = -(-(FIRST + KERNEL) // STRIDE)   # row offsets j - 3: 7
MAX_NARROW_C_OUT = 256   # C_out of the C_in = 1 kernel


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[B, C, 1, n] as its channels-last memory [B, n, C] (a copy only when
    ``t`` is not channels-last)."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], t.shape[-1], t.shape[1])


def _check(x: torch.Tensor, gy: torch.Tensor):
    if x.ndim != 4 or gy.ndim != 4 or x.shape[0] != gy.shape[0] \
            or x.shape[2] != 1 or gy.shape[2] != 1 \
            or x.shape[-1] != STRIDE * gy.shape[-1]:
        raise ValueError(f"conv1d_wgrad: x {tuple(x.shape)} and gy "
                         f"{tuple(gy.shape)} are no [B, C_in, 1, 4L] and "
                         "[B, C_out, 1, L]")


def conv1d_wgrad_plain(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The sum K6 computes, in torch: the seven products ``gy^T xv_j`` of
    the folded conv (xv_j the rows of xv shifted by j - 3, zeros outside),
    summed in float32 (float64 for float64 tensors) and rounded to x's
    type, as [C_out, C_in, 25]."""
    _check(x, gy)
    acc = torch.promote_types(x.dtype, torch.float32)
    b, c_in, length, c_out = x.shape[0], x.shape[1], gy.shape[-1], gy.shape[1]
    xv = F.pad(_rows(x).reshape(b, length, STRIDE * c_in).to(acc),
               (0, 0, PAST, TAPS - 1 - PAST))
    g = _rows(gy).reshape(b * length, c_out).to(acc)
    taps = torch.stack([g.T @ xv[:, j:j + length].reshape(b * length, -1)
                        for j in range(TAPS)])
    slots = taps.view(TAPS, c_out, STRIDE, c_in).permute(1, 3, 0, 2)
    return slots.reshape(c_out, c_in, TAPS * STRIDE)[
        ..., FIRST:FIRST + KERNEL].to(x.dtype)


def widths_fit(c_in: int, c_out: int) -> bool:
    """C_in = 1 with an even C_out of at most 256 (the CUDA-core kernel,
    which reads gy a pair of channels at a time), or an even C_in and C_out
    a multiple of 8 (TMA's 16-byte strides), as every WaveGAN layer has at
    d a multiple of 8."""
    return ((c_in == 1 and c_out % 2 == 0 and c_out <= MAX_NARROW_C_OUT)
            or (c_in % 2 == 0 and c_out % 8 == 0))


def wgrad_eligible(x: torch.Tensor, gy: torch.Tensor) -> bool:
    """Whether K6 takes the call: bf16 tensors on one card, at widths that
    :func:`widths_fit`."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and gy.dtype == torch.bfloat16 and gy.device == x.device
            and widths_fit(x.shape[1], gy.shape[1]))


def conv1d_wgrad_cudnn(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The same sum as cuDNN's weight gradient of ``conv2d`` over x padded
    10 | 11 along its length (channels-last kept), [C_out, C_in, 25]."""
    _check(x, gy)
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, LEFT, KERNEL - STRIDE - LEFT))
    w = gy.new_empty(1).expand(gy.shape[1], x.shape[1], 1, KERNEL)
    return torch.ops.aten.convolution_backward(
        gy, xp.permute(0, 3, 1, 2), w, None, (1, STRIDE), (0, 0), (1, 1),
        False, (0, 0), 1, (False, True, False))[1][:, :, 0]


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself when its channels-last memory is dense and 16-byte aligned,
    else such a copy."""
    if t.is_contiguous(memory_format=torch.channels_last) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.channels_last)


def _splits(b: int, length: int, c_in: int, c_out: int) -> int:
    fn = symbol("conv1d_wgrad", "conv1d_wgrad_splits", [I32] * 4)
    return fn(b, length, c_in, c_out)


def _launch(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    x, gy = _dense(x), _dense(gy)
    b, c_in, length, c_out = x.shape[0], x.shape[1], gy.shape[-1], gy.shape[1]
    splits = _splits(b, length, c_in, c_out)
    if splits <= 0:
        raise ValueError(f"conv1d_wgrad: K6 does not take B {b}, L {length}, "
                         f"C_in {c_in}, C_out {c_out}")
    partials = torch.empty((splits, TAPS, c_out, STRIDE * c_in),
                           dtype=torch.float32, device=x.device)
    dw = torch.empty((c_out, c_in, KERNEL), dtype=x.dtype, device=x.device)
    fn = symbol("conv1d_wgrad", "conv1d_wgrad_bf16", [PTR] * 4 + [I32] * 4
                + [PTR])
    launch("conv1d_wgrad", fn, x.device, x, gy, partials, dw, b, length,
           c_in, c_out)
    return dw


def conv1d_wgrad(x: torch.Tensor, gy: torch.Tensor,
                 role: str) -> torch.Tensor:
    """``dw`` [C_out, C_in, 25] of x [B, C_in, 1, 4L] and gy [B, C_out, 1,
    L] (see the module's docstring): K6 where :func:`wgrad_eligible` takes
    the call, counted under ``role`` (``"conv"`` or ``"transpose"``);
    cuDNN for float32 card tensors; the plain version on the CPU."""
    _check(x, gy)
    if not wgrad_eligible(x, gy):
        if x.device.type == "cpu" and gy.device.type == "cpu":
            return conv1d_wgrad_plain(x, gy)
        if x.dtype == gy.dtype == torch.float32 and gy.device == x.device:
            return conv1d_wgrad_cudnn(x, gy)
        raise ValueError(
            f"conv1d_wgrad: K6 takes bf16 at widths that widths_fit, cuDNN "
            f"float32; got x {x.dtype} on {x.device}, gy {gy.dtype} on "
            f"{gy.device}, C_in {x.shape[1]}, C_out {gy.shape[1]}")
    dw = _launch(x, gy)
    count("conv1d_wgrad", role, x.shape[0], gy.shape[-1], x.shape[1],
          gy.shape[1])
    return dw
