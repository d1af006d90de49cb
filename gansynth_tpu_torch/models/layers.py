"""Progressive-GAN building blocks in PyTorch (``gansynth_tpu/models/layers.py``).

- Equalized learning rate: weights are stored ~N(0, 1) and multiplied at
  call time by the He constant ``gain / sqrt(fan_in)``.
- Parameters are float32. ``compute_dtype`` is the activation and matmul
  type: inputs and scaled weights are cast to it before the op and the
  bias is added in it. Pixel norm reduces in float32 whatever the type.
- Public tensors are NHWC, as in the reference. Convolutions run on the
  NCHW view of the same memory (``permute`` without a copy, which PyTorch
  treats as channels-last), so no layer copies its input to change layout.
- Weights are OIHW (PyTorch's layout); ``utils.checkpoint`` converts the
  reference's HWIO kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gansynth_tpu_torch.kernels.conv import conv3x3_eligible, conv3x3_same
from gansynth_tpu_torch.utils.device import dtype_of, slope_in


def remat_call(module: nn.Module, *args) -> torch.Tensor:
    """``module(*args)`` with its activations rematerialised, the
    reference's ``nn.remat`` (``ModelConfig.remat``): non-reentrant
    ``torch.utils.checkpoint`` keeps only the inputs and runs the module
    again when the backward pass needs its activations, which also holds
    through the gradient penalty's double backward. The kernels' launches
    during that second run are counted apart
    (``kernels.recomputing``). The models draw no random numbers, so no
    RNG state is saved for the rerun (reading the CUDA generator's state
    is not allowed inside a CUDA graph capture)."""
    from gansynth_tpu_torch.kernels import recomputing

    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return module(*a)
        with recomputing():
            return module(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def he_scale(fan_in: int, gain: float) -> float:
    return gain / np.sqrt(float(fan_in))


def _normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator))


class EqualizedDense(nn.Module):
    """Dense layer with runtime He scaling. ``weight`` is [out, in]."""

    def __init__(self, in_features: int, features: int,
                 gain: float = np.sqrt(2.0), use_bias: bool = True,
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gain = gain
        self.compute_dtype = dtype_of(compute_dtype)
        self.weight = _normal((features, in_features), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        w = (self.weight * he_scale(x.shape[-1], self.gain)).to(cdt)
        y = F.linear(x.to(cdt), w)
        if self.bias is not None:
            y = y + self.bias.to(cdt)
        return y


class EqualizedConv(nn.Module):
    """SAME-padded stride-1 conv with runtime He scaling, NHWC in and out.

    A 1x1 conv with a fan-in of at most 4 channels is a broadcast
    multiply-add, as in the reference (``layers.py:103-107``). With
    ``conv_kernel="pallas"`` a 3x3 conv whose shape passes
    ``conv3x3_eligible`` runs through K2 (``kernels.conv.conv3x3_same``),
    as the reference routes it to its Pallas kernel (``layers.py:108-113``).
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 gain: float = np.sqrt(2.0), use_bias: bool = True,
                 compute_dtype: str = "float32", conv_kernel: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.gain = gain
        self.compute_dtype = dtype_of(compute_dtype)
        self.conv_kernel = conv_kernel
        self.weight = _normal((features, in_channels) + self.kernel_size,
                              generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        c_in = x.shape[-1]
        cdt = self.compute_dtype
        w = (self.weight * he_scale(kh * kw * c_in, self.gain)).to(cdt)
        xc = x.to(cdt)
        if (kh, kw) == (1, 1) and c_in <= 4:
            y = sum(xc[..., i:i + 1] * w[:, i, 0, 0] for i in range(c_in))
        elif self.conv_kernel == "pallas" and conv3x3_eligible(
                xc.shape, (kh, kw, c_in, w.shape[0])):
            y = conv3x3_same(xc.contiguous(), w)
        else:
            y = F.conv2d(xc.permute(0, 3, 1, 2), w,
                         padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(cdt)
        return y


def _smear_kernel_2x(kernel: torch.Tensor) -> torch.Tensor:
    """3x3 -> 4x4 (OIHW): full 2-D convolution with ones(2, 2).

    ``K'[a, b] = sum_{da, db in {0, 1}} K[a - da, b - db]``: nearest
    upsample x2 then a 3x3 SAME conv equals one stride-2 transposed conv
    with this kernel. Summed in the reference's order.
    """
    return (F.pad(kernel, (0, 1, 0, 1)) + F.pad(kernel, (0, 1, 1, 0))
            + F.pad(kernel, (1, 0, 0, 1)) + F.pad(kernel, (1, 0, 1, 0)))


class EqualizedUpConv(nn.Module):
    """Fused nearest-upsample(x2) + 3x3 eq-LR conv, NHWC in and out.

    The same sums as ``EqualizedConv`` on ``upsample_nearest(x, 2)``, with
    the same 3x3 weight, computed as one stride-2 ``conv_transpose2d``
    with the smeared 4x4 kernel: the reference's input-dilated conv with
    kernel ``k4`` and padding 2 is a transposed conv with the flipped,
    in/out-swapped ``k4`` and padding 4 - 1 - 2 = 1.
    """

    def __init__(self, in_channels: int, features: int,
                 gain: float = np.sqrt(2.0), use_bias: bool = True,
                 compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gain = gain
        self.compute_dtype = dtype_of(compute_dtype)
        self.weight = _normal((features, in_channels, 3, 3), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        k4 = _smear_kernel_2x(self.weight * he_scale(9 * x.shape[-1], self.gain))
        wt = k4.flip(-2, -1).transpose(0, 1).to(cdt)
        y = F.conv_transpose2d(x.to(cdt).permute(0, 3, 1, 2), wt, stride=2,
                               padding=1).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(cdt)
        return y


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2, channel axis) + eps), channel axis last.
    Reduces in float32; the output keeps the input's type."""
    x32 = x.float()
    s = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 * s).to(x.dtype)


def _mbstd_stat(x: torch.Tensor, group_size: int, eps: float) -> torch.Tensor:
    """The stddev feature map of one batch chunk: [B, H, W, C] -> [B, H, W,
    1], float32. Sample ``g_idx * (B/g) + m`` carries ``stat[m]``, as in
    the reference (``layers.py:204-214``)."""
    b, h, w, c = x.shape
    g = group_size if (group_size and b % group_size == 0) else b
    y = x.float().reshape(g, b // g, h, w, c)
    var = torch.mean(torch.square(y - torch.mean(y, dim=0, keepdim=True)),
                     dim=0)
    stat = torch.mean(torch.sqrt(var + eps), dim=(1, 2, 3), keepdim=True)
    return stat.repeat(g, h, w, 1)


def _mbstd_stats(x: torch.Tensor, group_size: int, eps: float,
                 num_replicas: int) -> torch.Tensor:
    b = x.shape[0]
    if num_replicas > b:
        num_replicas = 1
    if num_replicas <= 1:
        return _mbstd_stat(x, group_size, eps)
    if b % num_replicas:
        raise ValueError(f"batch {b} must divide num_replicas {num_replicas}")
    return torch.cat([_mbstd_stat(c, group_size, eps)
                      for c in x.chunk(num_replicas)])


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, eps: float = 1e-8,
                     num_replicas: int = 1, mesh=None) -> torch.Tensor:
    """Append one channel of batch-group stddev statistics: [B, H, W, C] ->
    [B, H, W, C + 1].

    ``num_replicas > 1`` splits the batch into that many contiguous chunks
    and never groups across them (per-replica statistics); more replicas
    than samples means whole-batch statistics, as in the reference.

    With a data-parallel ``mesh`` (``parallel.sharding.Mesh``), ``x`` is
    this rank's rows of a batch sharded over the ranks and the statistic
    is the global batch's, as the reference's GSPMD step takes it: the
    rank gathers the batch (differentiably), takes the statistic and keeps
    its rows. When each rank's rows are one replica's chunk
    (``num_replicas`` equal to the world size, ``--mbstd per-replica``),
    no collective is needed.
    """
    if mesh is not None and mesh.world > 1:
        if num_replicas == mesh.world:
            stat = _mbstd_stat(x, group_size, eps)
        else:
            full = mesh.gather(x)
            stat = _mbstd_stats(full, group_size, eps,
                                num_replicas)[mesh.rows(full.shape[0])]
    else:
        stat = _mbstd_stats(x, group_size, eps, num_replicas)
    return torch.cat([x, stat.to(x.dtype)], dim=-1)


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """x``factor`` average-pool downsample of an NHWC tensor: the sum over
    each window, then divided by ``factor**2``, in the input's type."""
    b, h, w, c = x.shape
    summed = x.reshape(b, h // factor, factor, w // factor, factor, c).sum(
        dim=(2, 4))
    return summed / float(factor * factor)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)`` with the slope rounded to x's type,
    as the reference's ``jax.nn.leaky_relu`` rounds it (see
    ``utils.device.slope_in``)."""
    return F.leaky_relu(x, negative_slope=slope_in(x.dtype, slope))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """x2 nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Fade-in ``a + (b - a) * t`` in the type of ``b``.

    ``b - a`` is taken in the activation type and the rest in float32, as
    the reference does with a float32 ``t`` (its samplers pass one).
    """
    return (a.float() + (b - a).float() * t).to(b.dtype)
