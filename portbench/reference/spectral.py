"""The mel-IF spectral frontend and synthesis of GANSynth (Engel et al.
2019; magenta's ``specgrams_helper``), in plain torch.

Analysis (the training data): pad the 64000-sample wave to 128 frames of
2048 at hop 512, periodic Hann, rFFT, drop the DC bin; log-magnitude
``log(|S| + eps)`` and instantaneous frequency (the time difference of
the unwrapped phase, over pi); through the 1024-band HTK mel matrix as
power (``log(exp(2 logmag) @ M + eps)``) and as accumulated phase
(``cumsum(IF pi) @ M``, IF taken again); the log power scaled from
[logmel_min, logmel_max] to [-1, 1]. The phase is unwrapped with a
cumulative sum and differenced, as magenta does.

Synthesis (a generated image): the inverse map through the mel matrix's
pseudo-inverse ``M^T diag(1 / colsum(M M^T))``, magnitude ``sqrt(exp(.) @
M+ + eps)``, phase ``cumsum(IF pi) @ M+``, polar to rectangular, inverse
rFFT with the least-squares synthesis window, overlap-add and crop. It
runs in float64.

``audio`` is the ``audio`` group of a ``configs/<config>.json``.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Mapping

import numpy as np
import torch


def _frozen(audio: Mapping) -> str:
    return json.dumps(dict(audio), sort_keys=True)


def pads(audio: Mapping):
    frames, hop, n = (audio["num_time_frames"], audio["frame_step"],
                      audio["frame_length"])
    total = (frames - 1) * hop + n - audio["audio_length"]
    left = int(total * audio["pad_left_fraction"])
    return left, total - left


def _hz_to_mel(f, audio):
    return audio["mel_break_mels"] * np.log1p(
        np.asarray(f, np.float64) / audio["mel_break_hertz"])


@functools.lru_cache(maxsize=4)
def _mel_arrays(key: str):
    """(M [F, mel], M+ [mel, F]) in float64: tf.signal's triangular HTK
    filterbank over ``linspace(0, nyquist, F)`` with the first bin zeroed,
    and the heuristic pseudo-inverse."""
    audio = json.loads(key)
    freq, mel = audio["num_freq_bins"], audio["num_mel_bins"]
    nyquist = audio["sample_rate"] / 2.0
    lin = _hz_to_mel(np.linspace(0.0, nyquist, freq)[1:], audio)[:, None]
    edges = np.linspace(_hz_to_mel(audio["mel_lower_hertz"], audio),
                        _hz_to_mel(audio["mel_upper_hertz"], audio), mel + 2)
    lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    m = np.maximum(0.0, np.minimum((lin - lower) / (center - lower),
                                   (upper - lin) / (upper - center)))
    m = np.pad(m, [[1, 0], [0, 0]])
    sums = (m @ m.T).sum(axis=0)
    d = np.where(np.abs(sums) > 1e-8, 1.0 / np.where(sums == 0, 1.0, sums),
                 sums)
    return m, m.T * d[None, :]


def mel_matrix(audio: Mapping, device, dtype=torch.float32) -> torch.Tensor:
    # The filterbank is stored float32, as every implementation keeps it.
    m = _mel_arrays(_frozen(audio))[0].astype(np.float32)
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def mel_pinv(audio: Mapping, device, dtype=torch.float64) -> torch.Tensor:
    m = _mel_arrays(_frozen(audio))[1].astype(np.float32)
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def hann(n: int, device, dtype) -> torch.Tensor:
    t = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * t / n)).to(dtype)


def instantaneous_frequency(phase: torch.Tensor) -> torch.Tensor:
    """magenta's ``instantaneous_frequency`` along the time axis (-2):
    unwrap (numpy.unwrap's rule, cumulative corrections), difference, the
    first frame kept, over pi."""
    dd = phase[..., 1:, :] - phase[..., :-1, :]
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    correct = torch.where(dd.abs() < math.pi, torch.zeros_like(dd),
                          ddmod - dd)
    unwrapped = phase + torch.cat([torch.zeros_like(phase[..., :1, :]),
                                   torch.cumsum(correct, dim=-2)], dim=-2)
    d = unwrapped[..., 1:, :] - unwrapped[..., :-1, :]
    return torch.cat([unwrapped[..., :1, :], d], dim=-2) / math.pi


def wave_to_image(wave: torch.Tensor, audio: Mapping) -> torch.Tensor:
    """[B, 64000] float32 -> [B, 128, 1024, 2] float32."""
    left, right = pads(audio)
    x = torch.nn.functional.pad(wave.float(), (left, right))
    frames = x.unfold(-1, audio["frame_length"], audio["frame_step"])
    spec = torch.fft.rfft(frames * hann(audio["frame_length"], x.device,
                                        torch.float32), dim=-1)
    spec = spec[..., 1:] if audio["discard_dc"] else spec[..., :-1]
    eps = audio["logmel_eps"]
    logmag = torch.log(spec.abs() + eps)
    ifreq = instantaneous_frequency(torch.angle(spec))
    m = mel_matrix(audio, x.device)
    logmel2 = torch.log(torch.exp(2.0 * logmag) @ m + eps)
    mel_if = instantaneous_frequency(torch.cumsum(ifreq * math.pi, dim=-2)
                                     @ m)
    lo, hi = audio["logmel_min"], audio["logmel_max"]
    ch0 = -1.0 + (logmel2 - lo) * 2.0 / (hi - lo)
    return torch.stack([ch0, mel_if], dim=-1)


def synthesis_window(audio: Mapping, device) -> torch.Tensor:
    n, hop = audio["frame_length"], audio["frame_step"]
    w = hann(n, device, torch.float64)
    denom = (w * w).reshape(n // hop, hop).sum(0).repeat(n // hop)
    return w / denom


def image_to_wave(image: torch.Tensor, audio: Mapping) -> torch.Tensor:
    """[B, 128, 1024, 2] -> [B, 64000] float64."""
    img = image.double()
    lo, hi = audio["logmel_min"], audio["logmel_max"]
    logmel2 = lo + (img[..., 0] + 1.0) * (hi - lo) / 2.0
    minv = mel_pinv(audio, img.device)
    mag = torch.sqrt(torch.clamp(torch.exp(logmel2) @ minv, min=0.0)
                     + audio["logmel_eps"])
    phase = torch.cumsum(img[..., 1] * math.pi, dim=-2) @ minv
    spec = torch.polar(mag, phase)
    pad = (1, 0) if audio["discard_dc"] else (0, 1)
    spec = torch.nn.functional.pad(spec, pad)
    n, hop = audio["frame_length"], audio["frame_step"]
    frames = torch.fft.irfft(spec, n=n, dim=-1) * synthesis_window(
        audio, img.device)
    b, t = frames.shape[0], frames.shape[1]
    length = (t - 1) * hop + n
    wave = torch.nn.functional.fold(
        frames.transpose(1, 2), output_size=(1, length), kernel_size=(1, n),
        stride=(1, hop)).reshape(b, length)
    left, _ = pads(audio)
    return wave[:, left:left + audio["audio_length"]]
