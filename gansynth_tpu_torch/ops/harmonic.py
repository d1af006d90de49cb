"""Fixed harmonic-template pitch classifier over mel-IF images
(``gansynth_tpu/ops/harmonic.py``).

A pitch classifier with no trainable parameters: for each conditioning
pitch, the time-averaged mel magnitude of a canonical harmonic note pushed
through a numpy replica of the training frontend (and the stage's average
pooling), L2-normalised. An image's logits are ``tau`` times the cosine of
its time-averaged mel magnitude with each template. The generator's
optional pitch-consistency loss uses it (``TrainConfig.
pitch_consistency_weight``). The templates are built by the reference's numpy
code, copied; only :func:`image_pitch_logits` runs in torch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gansynth_tpu_torch.ops.mel import linear_to_mel_matrix
from gansynth_tpu_torch.ops.spectral import constant_cache
from gansynth_tpu_torch.ops.windows import hann_window
from gansynth_tpu_torch.utils.config import AudioConfig, Config, scale


def _hz_to_mel(f, break_hertz: float, break_mels: float):
    return break_mels * np.log1p(np.asarray(f, dtype=np.float64) / break_hertz)


def midi_to_hz(pitch) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(pitch, dtype=np.float64) - 69.0) / 12.0)


@functools.lru_cache(maxsize=None)
def _templates_cached(
    audio: AudioConfig, pitch_min: int, num_pitches: int, pool: int
) -> np.ndarray:
    """[num_pitches, num_mel_bins // pool] unit-L2 harmonic templates.

    EMPIRICAL construction: each template is a canonical harmonic note
    (1/k-amplitude partials at the pitch's harmonics, constant envelope)
    pushed through a numpy replica of the exact training frontend — pad /
    periodic-Hann STFT / DC drop / mel / log / [-1, 1] scale, then the
    stage's average-pooling IN THE SCALED LOG DOMAIN, then the
    classifier's own exp readout. This inherits every pipeline quirk by
    construction: the mel matrix's off-by-one-bin frequency grid
    (ops/mel.py docstring — a hand-built analytic template grid misread
    the bottom two octaves by three semitones until that mapping was
    added), the window mainlobe shapes, and the geometric-mean distortion
    that log-domain pooling inflicts on narrow peaks at the low stages.

    Cached per (audio config, pitch range, stage pool factor); configs are
    frozen dataclasses, so they key the cache directly.
    """
    l2m = linear_to_mel_matrix(
        num_mel_bins=audio.num_mel_bins,
        num_spectrogram_bins=audio.num_freq_bins,
        sample_rate=audio.sample_rate,
        lower_edge_hertz=audio.mel_lower_hertz,
        upper_edge_hertz=audio.mel_upper_hertz,
        dtype=np.float64,
    )
    window = hann_window(audio.frame_length, dtype=np.float64)
    t_axis = np.arange(audio.audio_length, dtype=np.float64)
    nyquist = audio.sample_rate / 2.0
    frames_idx = (
        np.arange(audio.num_time_frames)[:, None] * audio.frame_step
        + np.arange(audio.frame_length)[None, :]
    )

    out = np.zeros((num_pitches, audio.num_mel_bins // pool))
    for i in range(num_pitches):
        f0 = float(midi_to_hz(pitch_min + i))
        wave = np.zeros(audio.audio_length)
        for k in range(1, int(nyquist / f0) + 1):
            wave += (1.0 / k) * np.sin(
                2.0 * np.pi * k * f0 * t_axis / audio.sample_rate
            )
        wave = np.pad(wave, (audio.pad_left, audio.pad_right))
        spec = np.fft.rfft(wave[frames_idx] * window, axis=-1)
        if audio.discard_dc:
            spec = spec[:, 1:]
        else:
            spec = spec[:, :-1]
        lmm2 = np.log(np.square(np.abs(spec)) @ l2m + audio.logmel_eps)
        ch0 = scale(lmm2, audio.logmel_min, audio.logmel_max, -1.0, 1.0)
        if pool > 1:
            ch0 = ch0.reshape(
                audio.num_time_frames // pool, pool,
                audio.num_mel_bins // pool, pool,
            ).mean(axis=(1, 3))
        # The classifier's readout applied to the canonical note.
        mag = np.exp(
            0.5 * scale(ch0, -1.0, 1.0, audio.logmel_min, audio.logmel_max)
        ).mean(axis=0)
        out[i] = mag / (np.linalg.norm(mag) + 1e-12)
    return out.astype(np.float32)


def harmonic_pitch_templates(config: Config, stage: int) -> np.ndarray:
    """Unit-norm templates matching the image's mel axis at ``stage``."""
    pool = 1 << (config.model.num_stages - 1 - stage)
    return _templates_cached(
        config.audio, config.model.pitch_min, config.model.num_pitches, pool
    )


@constant_cache
def _device_templates(config: Config, stage: int,
                      device: torch.device) -> torch.Tensor:
    """:func:`harmonic_pitch_templates` on ``device``, copied once (a copy
    per step would stall the host, and cannot be captured in a CUDA
    graph)."""
    return torch.from_numpy(harmonic_pitch_templates(config, stage)).to(device)


def image_pitch_logits(image: torch.Tensor, stage: int, config: Config,
                       tau: float = 40.0) -> torch.Tensor:
    """Differentiable pitch logits [B, num_pitches] from an image [B, H, W,
    2] at ``stage`` (channel 0 the [-1, 1]-scaled log-mel-mag^2), in
    float32 whatever the image's type."""
    templates = _device_templates(config, stage, image.device)
    logmelmag2 = scale(image[..., 0].float(), -1.0, 1.0,
                       config.audio.logmel_min, config.audio.logmel_max)
    spec = torch.mean(torch.exp(0.5 * logmelmag2), dim=-2)
    spec = spec / (torch.linalg.vector_norm(spec, dim=-1, keepdim=True)
                   + 1e-12)
    return tau * (spec @ templates.T)
