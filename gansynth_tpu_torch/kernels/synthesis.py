"""K1: the synthesis-spectrum kernel and its plain version.

``synthesis_spectrum`` replaces the TPU kernel
``gansynth_tpu/kernels/pallas_synthesis.py:synthesis_spectrum_pallas``: a
mel-IF image [B, 128, 1024, 2] f32 becomes the linear spectrum (Re, Im)
[B, 128, 1024] f32 that feeds the iSTFT. For a CUDA tensor it launches the
CUDA kernel of ``csrc/synthesis_spectrum.cu`` (built by ``nvcc`` on first
use), one launch that gathers each linear bin's <= 2 mel taps (the
nonzeros of the mel pseudo-inverse, from :func:`tap_tables`); for a CPU
tensor it calls :func:`synthesis_spectrum_plain`. There is no fallback
from one to the other. Both sit behind the operator
``gansynth_torch::synthesis_spectrum``, which ``torch.export`` keeps as
one node of an exported program (``synth/export.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gansynth_tpu_torch.kernels import count
from gansynth_tpu_torch.kernels._build import F32, I32, PTR, launch, symbol
from gansynth_tpu_torch.ops.spectral import constant_cache, mel_pinv
from gansynth_tpu_torch.utils.config import AudioConfig, scale

_PI = np.pi
_SYMBOLS = {torch.float32: "synthesis_spectrum_f32"}
TAPS = 2     # mel taps per linear bin that the kernel takes
STRIP = 16   # linear bins per block (kStrip in the source, which checks
             # that the strip table has freq_bins / 16 rows)


def tap_tables(m2l: np.ndarray):
    """The nonzeros of ``m2l`` [M, F] by column: ``(index, weight)``, both
    [F, TAPS] and C-contiguous, int32 and float32. Row f lists the mel rows
    of column f's nonzeros in ascending order and their values; a column
    with fewer than ``TAPS`` nonzeros is padded with index -1 and weight 0.
    Raises if a column has more than ``TAPS`` nonzeros."""
    m2l = np.asarray(m2l, dtype=np.float32)
    freq_bins = m2l.shape[1]
    f, m = np.nonzero(m2l.T)            # by column, rows ascending
    counts = np.bincount(f, minlength=freq_bins)
    if counts.max(initial=0) > TAPS:
        worst = int(np.argmax(counts))
        raise ValueError(
            f"column {worst} of the mel pseudo-inverse has {counts[worst]} "
            f"nonzeros; the synthesis kernel takes at most {TAPS}"
        )
    rank = np.arange(f.size) - np.searchsorted(f, f)
    index = np.full((freq_bins, TAPS), -1, dtype=np.int32)
    weight = np.zeros((freq_bins, TAPS), dtype=np.float32)
    index[f, rank] = m
    weight[f, rank] = m2l[m, f]
    return index, weight


def strip_spans(index: np.ndarray) -> np.ndarray:
    """``(m_lo, span)`` [F / STRIP, 2] int32: the mel columns
    ``[m_lo, m_lo + span)`` that the taps of each strip of ``STRIP`` linear
    bins touch, with ``m_lo`` and ``span`` rounded out to even numbers (the
    kernel loads (x, y) pairs of two mel columns, 16 bytes at a time)."""
    freq_bins = index.shape[0]
    if freq_bins % STRIP:
        raise ValueError(f"{freq_bins} linear bins are not a whole number "
                         f"of strips of {STRIP}")
    spans = np.zeros((freq_bins // STRIP, 2), dtype=np.int32)
    for s in range(freq_bins // STRIP):
        used = index[s * STRIP:(s + 1) * STRIP]
        used = used[used >= 0]
        if used.size:
            lo = int(used.min()) // 2 * 2
            width = int(used.max()) + 1 - lo
            spans[s] = (lo, width + width % 2)
    return spans


@constant_cache
def _device_taps(config: AudioConfig, device: torch.device):
    """``(index, weight, strips, span_max)`` of the config's mel
    pseudo-inverse, the tables on ``device``."""
    index, weight = tap_tables(mel_pinv(config, "cpu").numpy())
    strips = strip_spans(index)
    span_max = max(2, int(strips[:, 1].max()))
    return (*(torch.from_numpy(a).to(device) for a in (index, weight, strips)),
            span_max)


def _spectrum_plain(image: torch.Tensor, m2l: torch.Tensor,
                    logmel_min: float, logmel_max: float, eps: float):
    logmelmag2 = scale(image[..., 0], -1.0, 1.0, logmel_min, logmel_max)
    mag2 = torch.exp(logmelmag2) @ m2l
    mag = torch.sqrt(torch.clamp(mag2, min=0.0) + eps)
    phase = torch.cumsum(image[..., 1] * _PI, dim=-2) @ m2l
    return mag * torch.cos(phase), mag * torch.sin(phase)


def synthesis_spectrum_plain(image: torch.Tensor, config: AudioConfig):
    """Mel-IF image [..., T, M, 2] -> (Re, Im) linear spectrum [..., T, F].

    The literal PyTorch form of ``melspecgrams_to_wave`` up to the iDFT:
    un-scale channel 0, exp, mel pseudo-inverse, ``sqrt(max(., 0) +
    eps)``; channel 1 times pi, time cumsum, mel pseudo-inverse; polar ->
    rect. The CPU tests and the kernel's check on the card use it; the
    CUDA path of the port never calls it.
    """
    return _spectrum_plain(image, mel_pinv(config, image.device),
                           config.logmel_min, config.logmel_max,
                           config.logmel_eps)


def _check(image: torch.Tensor, config: AudioConfig) -> None:
    if image.dtype != torch.float32:
        raise TypeError(f"synthesis_spectrum needs float32, got {image.dtype}")
    expected = (config.num_time_frames, config.num_mel_bins, 2)
    if image.ndim != 4 or tuple(image.shape[1:]) != expected:
        raise ValueError(
            f"synthesis_spectrum needs an image [B, {expected[0]}, "
            f"{expected[1]}, 2], got {tuple(image.shape)}"
        )
    if not config.num_mel_bins == config.num_freq_bins == 1024:
        raise ValueError(
            "synthesis_spectrum is built for 1024 mel and 1024 linear bins, "
            f"got {config.num_mel_bins} and {config.num_freq_bins}"
        )
    if not image.is_contiguous():
        raise ValueError("synthesis_spectrum needs a contiguous image")


def _kernel(dtype: torch.dtype):
    return symbol("synthesis_spectrum", _SYMBOLS[dtype],
                  [PTR] * 4 + [I32] * 2 + [PTR] * 2 + [I32] * 4 + [F32] * 3
                  + [PTR])


def _spectrum_cpu(image: torch.Tensor, m2l: torch.Tensor, index: torch.Tensor,
                  weight: torch.Tensor, strips: torch.Tensor, span_max: int,
                  logmel_min: float, logmel_max: float,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if image.device.type != "cpu":
        raise ValueError(f"synthesis_spectrum: unsupported device {image.device}")
    return _spectrum_plain(image, m2l, logmel_min, logmel_max, eps)


def _spectrum_cuda(image, m2l, index, weight, strips, span_max, logmel_min,
                   logmel_max, eps):
    if image.data_ptr() % 16:
        raise ValueError("synthesis_spectrum needs a 16-byte aligned image")
    batch, frames, mel_bins, _ = image.shape
    freq_bins = index.shape[0]
    fn = _kernel(image.dtype)
    re = torch.empty((batch, frames, freq_bins), dtype=torch.float32,
                     device=image.device)
    im = torch.empty_like(re)
    # Inverse of scale(x, logmel_min, logmel_max, -1, 1): x * a + b.
    a = (logmel_max - logmel_min) / 2.0
    b = (logmel_max + logmel_min) / 2.0
    launch("synthesis_spectrum kernel", fn, image.device, image, index,
           weight, strips, strips.shape[0], span_max, re, im, batch, frames,
           mel_bins, freq_bins, a, b, eps)
    count("synthesis_spectrum", "forward", batch)
    return re, im


def _spectrum_fake(image, m2l, index, weight, strips, span_max, logmel_min,
                   logmel_max, eps):
    if image.dim() != 4 or image.shape[-1] != 2:
        raise ValueError(f"synthesis_spectrum needs an image [B, T, M, 2], "
                         f"got {tuple(image.shape)}")
    shape = (image.shape[0], image.shape[1], index.shape[0])
    return image.new_empty(shape), image.new_empty(shape)


# K1 as an operator of its own, so that a torch.export trace keeps it as one
# node (serialized by name, dispatched by the device at run time) and an
# exported sampler launches the kernel wherever it runs. The tables ride
# as inputs, so the program carries them; ``m2l`` feeds the CPU version.
_spectrum_op = torch.library.custom_op(
    "gansynth_torch::synthesis_spectrum", _spectrum_cpu, mutates_args=())
_spectrum_op.register_kernel("cuda")(_spectrum_cuda)
_spectrum_op.register_fake(_spectrum_fake)
_EAGER = {"cpu": _spectrum_cpu, "cuda": _spectrum_cuda}


def synthesis_spectrum(image: torch.Tensor, config: AudioConfig):
    """[B, 128, 1024, 2] f32 image -> (Re, Im) [B, 128, 1024] f32.

    Launches the CUDA kernel for a CUDA tensor (and counts the launch,
    ``kernels.count``); takes the plain version for a CPU
    tensor; raises on any other device or on a shape, type, layout or
    alignment the kernel does not take. Under a trace (a tensor subclass)
    it calls the operator ``gansynth_torch::synthesis_spectrum``, whose
    kernels these are; eagerly it calls them directly, which spares the
    dispatcher's host time (tens of microseconds a call).
    """
    _check(image, config)
    index, weight, strips, span_max = _device_taps(config, image.device)
    args = (image, mel_pinv(config, image.device), index, weight, strips,
            span_max, config.logmel_min, config.logmel_max,
            config.logmel_eps)
    if type(image) is torch.Tensor:
        return _EAGER.get(image.device.type, _spectrum_cpu)(*args)
    return torch.ops.gansynth_torch.synthesis_spectrum(*args)
