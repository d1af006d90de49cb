"""WaveGAN (Donahue, McAuley and Puckette, "Adversarial Audio Synthesis",
ICLR 2019, arXiv:1802.04208; ``chrisdonahue/wavegan`` ``wavegan.py``) at
``slice_len`` 65536: a 1-D generator and critic of waveforms, conditioned
on pitch as the flagship is (``ModelConfig.architecture = "wavegan"``).

Shapes are [length, channels] for one note, d = ``wavegan_dim``, kernel
25, stride 4 (:data:`KERNEL`, :data:`STRIDE`: the public code's at
``slice_len`` 65536, :data:`SLICE_LEN`); every conv has a bias and there
is no batch norm.

- Generator: ``z_project``, dense ``(latent + pitches) -> 16 * 32d``,
  reshaped to [16, 32d], ReLU; ``upconv_0..4``, transposed convs 32d ->
  16d -> 8d -> 4d -> 2d -> d, each x4 in length, ReLU; ``upconv_5``, d ->
  1, tanh: [65536, 1].
- Critic: ``downconv_0..5``, "SAME" convs 1 -> d -> ... -> 32d, each /4 in
  length, LeakyReLU 0.2, phase shuffle after ``downconv_0..3``; the
  [16, 32d] output flattened (length-major) into ``critic_head`` (one
  score) and ``pitch_head`` (pitch logits).

A "SAME" conv pads its input of length 4L by ``(k - s) // 2`` = 10 on the
left and 11 on the right (TF's split); a transposed conv is that conv's
gradient: the full output of length 4L + 21 cropped to [10, 10 + 4L).
Phase shuffle (``apply_phaseshuffle``) reflect-pads by ``max(s, 0)`` on
the left and ``max(-s, 0)`` on the right and crops back to the length
from ``max(-s, 0)``: ``y[t] = x[reflect(t - s)]``. The shift ``s`` in
-2..2 (:data:`RADIUS`) is one draw a critic call and layer for the whole
batch, handed in as a device tensor (a CUDA graph freezes Python ints),
so the shuffle is a gather at indices built on the device; its backward
is an ``index_add``, itself differentiable, which the penalty's second
order runs through.

Layout: activations are [B, C, 1, L] tensors in channels-last memory
([B, 1, L, C]), the convs ``conv2d`` and ``conv_transpose2d`` with
kernel (1, 25): on an H100 at batch 64 their forward and backward took
8.2 ms over the generator's six layers against 21.6 ms as NCL
``conv1d``, and 32.6 against 39.1 over the critic's (PERF.md). Pads and
gathers run on the [B, 1, L, C] view, so every tensor stays
channels-last.

Gradients: the SAME conv ``C(x, w)``, its input gradient ``T(gy, w)``
(the transposed conv, cropped) and its weight gradient ``W(x, gy)``
(K6, ``kernels/conv1d_wgrad.py``) are three autograd functions, each
differentiable through the others: ``C``'s derivatives are ``T(gy, w)``
and ``W(x, gy)``, ``T``'s ``C(ggx, w)`` and ``W(ggx, gy)``, ``W``'s
``T(gy, ggw)`` and ``C(x, ggw)``. So every weight gradient, the
penalty's second-order term and the generator's transposed convs'
included, is K6's in bf16 on a card (float32 takes cuDNN's, the CPU the
plain sum: ``conv1d_wgrad``), while the forwards and input gradients
stay cuDNN's calls. A function computes only the gradients that the
running backward pass will use: the engine says so for each input's edge
(``_will_engine_execute_node``); ``ctx.needs_input_grad`` is fixed at the
forward and cannot see that the penalty's first-order call or the
generator update's pass through the critic reads no critic weight.
Parameters are float32, weights stored as PyTorch's 1-D layouts (conv
[out, in, k], transposed conv [in, out, k], dense [out, in]);
``compute_dtype`` is the convs' and the hidden dense layer's type, the
two heads run in float32 as the flagship's do.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gansynth_tpu_torch.kernels.conv1d_wgrad import (
    KERNEL,
    LEFT,
    STRIDE,
    conv1d_wgrad,
)
from gansynth_tpu_torch.utils.config import ModelConfig
from gansynth_tpu_torch.utils.device import dtype_of

LAYERS = 6      # up- and down-convs a network
SLICE_LEN = 65536   # samples a note
BASE = SLICE_LEN // STRIDE ** LAYERS   # the generator's first length, 16
SHUFFLED = 4    # critic layers followed by phase shuffle
RADIUS = 2      # phase shuffle's largest shift
CALLS = 3       # critic calls a critic update: real, fake, interpolates


def widths(m: ModelConfig) -> Tuple[int, ...]:
    """The critic's channels from the wave up: 1, d, 2d, ..., 32d."""
    return (1,) + tuple(m.wavegan_dim << i for i in range(LAYERS))


def _pad_length(h: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Zero-pad the length of a channels-last [B, C, 1, L] tensor."""
    return F.pad(h.permute(0, 2, 3, 1), (0, 0, left, right)).permute(
        0, 3, 1, 2)


def _conv(x, w, b=None):
    return F.conv2d(_pad_length(x, LEFT, KERNEL - STRIDE - LEFT),
                    w.unsqueeze(2), b, stride=(1, STRIDE))


def _conv_t(gy, w):
    y = F.conv_transpose2d(gy, w.unsqueeze(2), stride=(1, STRIDE),
                           padding=(0, LEFT))
    return y[..., :STRIDE * gy.shape[-1]]


def _wanted(ctx, i: int, t: torch.Tensor) -> bool:
    """Whether the running backward pass uses the gradient of input ``i``
    (``t``): asked for, and its edge one that the engine will execute."""
    if not ctx.needs_input_grad[i]:
        return False
    node = torch.autograd.graph.get_gradient_edge(t).node
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError as e:
        # the engine refuses the question for a leaf that autograd.grad()
        # was asked for: that gradient is used
        if "leaf node" not in str(e):
            raise
        return True


class _SameConv(torch.autograd.Function):
    """``C(x, w) + b``: TF's "SAME" conv, x [B, C_in, 1, 4L] -> [B, C_out,
    1, L], w [C_out, C_in, 25], b [C_out] or None."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _conv(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w, b = ctx.saved_tensors
        dx = _SameConvT.apply(gy, w) if _wanted(ctx, 0, x) else None
        dw = _Wgrad.apply(x, gy, "conv") if _wanted(ctx, 1, w) else None
        db = gy.sum((0, 2, 3)) if _wanted(ctx, 2, b) else None
        return dx, dw, db


class _SameConvT(torch.autograd.Function):
    """``T(gy, w)``: the input gradient of :class:`_SameConv`, the full
    transposed conv of gy [B, C_out, 1, L] cropped to [10, 10 + 4L)."""

    @staticmethod
    def forward(ctx, gy, w):
        ctx.save_for_backward(gy, w)
        return _conv_t(gy, w)

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        dgy = _SameConv.apply(ggx, w, None) if _wanted(ctx, 0, gy) else None
        dw = _Wgrad.apply(ggx, gy, "transpose") if _wanted(ctx, 1, w) \
            else None
        return dgy, dw


class _Wgrad(torch.autograd.Function):
    """``W(x, gy)``: the weight gradient of :class:`_SameConv`, [C_out,
    C_in, 25] (K6; ``role`` files its launches)."""

    @staticmethod
    def forward(ctx, x, gy, role):
        ctx.save_for_backward(x, gy)
        return conv1d_wgrad(x, gy, role)

    @staticmethod
    def backward(ctx, ggw):
        x, gy = ctx.saved_tensors
        dx = _SameConvT.apply(gy, ggw) if _wanted(ctx, 0, x) else None
        dgy = _SameConv.apply(x, ggw, None) if _wanted(ctx, 1, gy) else None
        return dx, dgy, None


def _check_geometry(w: torch.Tensor, stride: int) -> None:
    if w.shape[-1] != KERNEL or stride != STRIDE:
        raise ValueError(f"WaveGAN's convs have kernel {KERNEL} and stride "
                         f"{STRIDE}, got {w.shape[-1]} and {stride}")


def same_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int) -> torch.Tensor:
    """TF's "SAME" strided conv of [B, C_in, 1, L] (w [out, in, k]),
    kernel 25 and stride 4."""
    _check_geometry(w, stride)
    return _SameConv.apply(h, w, b)


def same_conv_transpose(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """The gradient of :func:`same_conv` as a layer (w [in, out, k]):
    length L -> stride * L."""
    _check_geometry(w, stride)
    y = _SameConvT.apply(h, w)
    return y if b is None else y + b.view(1, -1, 1, 1)


def phase_shuffle(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``y[..., t] = h[..., reflect(t - shift)]`` along the length of a
    channels-last [B, C, 1, L] tensor; ``shift`` a 0-d integer tensor on
    its device, with ``|shift| < L``."""
    n = h.shape[-1]
    t = (torch.arange(n, device=h.device) - shift).abs()
    idx = torch.where(t > n - 1, 2 * (n - 1) - t, t)
    return h.permute(0, 2, 3, 1).index_select(2, idx).permute(0, 3, 1, 2)


class _Conv(nn.Module):
    """A conv's parameters: ``weight`` [out, in, k] ([in, out, k] when
    ``transposed``) and ``bias`` [out]."""

    def __init__(self, c_in: int, c_out: int, kernel: int,
                 transposed: bool = False):
        super().__init__()
        shape = (c_in, c_out, kernel) if transposed else (c_out, c_in, kernel)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(c_out))


class _Dense(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class WaveGANGenerator(nn.Module):
    """latents [B, D] + one-hot pitch [B, P] -> waves [B, slice_len]
    float32. ``stage`` and ``alpha`` are taken and ignored, so that the
    train step calls both families alike."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = m = config
        self.cdt = dtype_of(m.compute_dtype)
        chans = widths(m)[::-1]
        self.z_project = _Dense(m.latent_dim + m.num_pitches,
                                BASE * chans[0])
        for i in range(LAYERS):
            setattr(self, f"upconv_{i}", _Conv(chans[i], chans[i + 1],
                                               KERNEL, True))

    def forward(self, z: torch.Tensor, labels: torch.Tensor, stage: int = 0,
                alpha=1.0) -> torch.Tensor:
        x = torch.cat([z, labels.to(z.dtype)], dim=-1).to(self.cdt)
        x = F.relu(self.z_project(x))
        # [B, 16, 32d] (length-major, as TF reshapes) as [B, 32d, 1, 16]
        h = x.view(z.shape[0], 1, BASE, -1).permute(0, 3, 1, 2)
        for i in range(LAYERS):
            conv = getattr(self, f"upconv_{i}")
            h = same_conv_transpose(h, conv.weight.to(self.cdt),
                                    conv.bias.to(self.cdt), STRIDE)
            if i < LAYERS - 1:
                h = F.relu(h)
        return torch.tanh(h[:, 0, 0].float())


class WaveGANDiscriminator(nn.Module):
    """waves [B, SLICE_LEN] -> (critic score [B], pitch logits [B, P]),
    both float32. ``shifts`` (int64 [4] on the waves' device) are the
    call's phase-shuffle shifts, one a shuffled layer."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = m = config
        self.cdt = dtype_of(m.compute_dtype)
        chans = widths(m)
        for i in range(LAYERS):
            setattr(self, f"downconv_{i}", _Conv(chans[i], chans[i + 1],
                                                 KERNEL))
        flat = BASE * chans[-1]
        self.critic_head = _Dense(flat, 1)
        self.pitch_head = _Dense(flat, m.num_pitches)

    def forward(self, x: torch.Tensor, shifts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.to(self.cdt).view(x.shape[0], 1, 1, -1)
        for i in range(LAYERS):
            conv = getattr(self, f"downconv_{i}")
            h = F.leaky_relu(same_conv(h, conv.weight.to(self.cdt),
                                       conv.bias.to(self.cdt), STRIDE),
                             self.config.leaky_relu_slope)
            if i < SHUFFLED:
                h = phase_shuffle(h, shifts[i])
        flat = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        return self.critic_head(flat)[:, 0], self.pitch_head(flat)


def make_wavegan_sampler(config, ema: nn.Module):
    """``sample(key, pitches) -> (waves [P, audio_length], None)``: the
    generator's notes at ``pitches`` from latents uniform on [-1, 1)
    drawn from ``key``, cut to the audio length (no image: the training
    loop's sample dumps)."""
    from gansynth_tpu_torch.synth import random as jrandom

    m = config.model

    @torch.no_grad()
    def sample(key, pitches):
        device = next(ema.parameters()).device
        z = jrandom.uniform_from_bits(
            jrandom.random_bits(key, (len(pitches), m.latent_dim)),
            np.float32(-1.0), np.float32(1.0))
        idx = torch.clamp(torch.as_tensor(pitches).long() - m.pitch_min, 0,
                          m.num_pitches - 1)
        labels = F.one_hot(idx, m.num_pitches).float().to(device)
        waves = ema(torch.from_numpy(z).to(device), labels)
        return waves[:, :config.audio.audio_length], None

    return sample


@torch.no_grad()
def init_wavegan(network: nn.Module, key: Tuple[int, int]) -> None:
    """In place: TF's defaults in ``wavegan.py``, Glorot-uniform kernels
    (limit ``sqrt(6 / (fan_in + fan_out))``, a conv's fans its kernel
    width times its channels) and zero biases, drawn on the host from a
    generator seeded by ``key`` in the order of ``named_parameters``."""
    gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
    for _, p in network.named_parameters():
        if p.ndim == 1:
            p.zero_()
            continue
        taps = p.shape[2] if p.ndim == 3 else 1
        limit = math.sqrt(6.0 / (taps * (p.shape[0] + p.shape[1])))
        p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * limit)


def wavegan_noise(rng, step: int, batch: int, latent_dim: int,
                  updates: int):
    """A WaveGAN step's noise (the program's contract, which the plain
    reference follows): ``keys = split(fold_in(rng, step), 3 n + 2)`` for
    ``n`` critic updates; update j draws its latents ``z_d[j]`` (uniform
    on [-1, 1), [batch, latent]) from ``keys[3 j]``, its interpolation
    weights ``u[j]`` (uniform on [0, 1), [batch]) from ``keys[3 j + 1]``
    and the shifts of its three critic calls ``shifts_d[j]`` (int
    [3, 4]: real, fake, interpolates by shuffled layer) from ``keys[3 j +
    2]``; the generator update its latents ``z_g`` from ``keys[3 n]`` and
    its critic call's shifts ``shifts_g`` [4] from ``keys[3 n + 1]``. A
    shift is ``bits mod 5 - 2`` of 32 random bits (-2..2,
    :data:`RADIUS`). Each critic update's batch is the cached stream's at position
    ``step * n + j``; the generator update takes the last one's labels.
    Float32 and int32 numpy arrays."""
    from gansynth_tpu_torch.synth import random as jrandom

    keys = jrandom.split(jrandom.fold_in(rng, step), 3 * updates + 2)

    def latents(key):
        return jrandom.uniform_from_bits(
            jrandom.random_bits(key, (batch, latent_dim)), np.float32(-1.0),
            np.float32(1.0))

    return {"z_d": np.stack([latents(keys[3 * j]) for j in range(updates)]),
            "u": np.stack([jrandom.uniform(keys[3 * j + 1], (batch,))
                           for j in range(updates)]),
            "z_g": latents(keys[3 * updates]),
            "shifts_d": np.stack([shifts(keys[3 * j + 2], (CALLS, SHUFFLED))
                                  for j in range(updates)]),
            "shifts_g": shifts(keys[3 * updates + 1], (SHUFFLED,))}


def shifts(key, shape) -> np.ndarray:
    """Phase-shuffle shifts in -RADIUS..RADIUS (int32)."""
    from gansynth_tpu_torch.synth import random as jrandom

    bits = jrandom.random_bits(key, shape)
    return (bits % np.uint32(2 * RADIUS + 1)).astype(np.int32) - RADIUS
