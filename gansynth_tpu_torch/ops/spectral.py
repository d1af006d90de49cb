"""The spectral library, in PyTorch (``gansynth_tpu/ops/spectral.py``).

Both directions of the reference:

- analysis (training data): wave [..., 64000] -> pad, frame, periodic
  Hann, rFFT (or the windowed DFT matmuls), drop DC -> log-magnitude and
  instantaneous frequency -> through the mel matrix -> the image
  [..., 128, 1024, 2];
- synthesis (the generated image):

    image [..., 128, 1024, 2]
    -> un-scale ch0, exp, @ mel pseudo-inverse, sqrt       (magnitude)
    -> ch1 * pi, time cumsum, @ mel pseudo-inverse          (phase)
    -> polar -> rect -> iDFT with the synthesis window -> overlap-add
    -> crop -> wave [..., 64000]

All spectral math stays float32. The numpy constant builders (windows,
mel matrices, DFT and iDFT matrices) are the reference's, built in float64
and stored float32; each is moved to a device once and cached
(:func:`constant_cache`, which holds real tensors even when a
``torch.export`` trace is the first caller).

On a card :func:`spectral_calls` runs each direction as one CUDA graph a
batch size (the reference's two ``jax.jit``).

Array layout as in the reference: waves ``[..., time]``, spectrograms
``[..., frames, bins]``, images ``[..., frames, bins, 2]`` with channel 0
the scaled log-mel-magnitude and channel 1 the mel-IF.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from gansynth_tpu_torch.ops.mel import linear_to_mel_matrix, mel_to_linear_matrix
from gansynth_tpu_torch.ops.windows import hann_window, inverse_stft_window
from gansynth_tpu_torch.utils.config import AudioConfig, scale

_PI = np.pi


def diff(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Finite difference along ``axis`` (the length shrinks by one)."""
    n = x.shape[axis]
    return x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)


def _wrapped_diff(phase: torch.Tensor, axis: int):
    """``(dd, ddmod)``: the phase difference along ``axis`` and its value
    wrapped into [-pi, pi), with numpy.unwrap's tie-break (a jump of
    exactly -pi with a positive raw difference maps to +pi). ``jnp.mod``
    is a floor mod, hence ``torch.remainder``."""
    dd = diff(phase, axis=axis)
    ddmod = torch.remainder(dd + _PI, 2.0 * _PI) - _PI
    ddmod = torch.where((ddmod == -_PI) & (dd > 0), _PI, ddmod)
    return dd, ddmod


def unwrap(phase: torch.Tensor, axis: int = -2,
           discont: float = _PI) -> torch.Tensor:
    """Phase unwrapping along ``axis`` with numpy.unwrap's semantics."""
    dd, ddmod = _wrapped_diff(phase, axis)
    ph_correct = torch.where(dd.abs() < discont, 0.0, ddmod - dd)
    corrections = torch.cumsum(ph_correct, dim=axis)
    first = torch.zeros_like(phase.narrow(axis, 0, 1))
    return phase + torch.cat([first, corrections], dim=axis)


def instantaneous_frequency(phase: torch.Tensor,
                            axis: int = -2) -> torch.Tensor:
    """IF in [-1, 1]: the time difference of the unwrapped phase over pi,
    with the first frame prepended so the length is kept. The unwrap's
    cumsum cancels in the difference, so this is elementwise, as in the
    reference."""
    dd, ddmod = _wrapped_diff(phase, axis)
    dphase = torch.where(dd.abs() < _PI, dd, ddmod)
    return torch.cat([phase.narrow(axis, 0, 1), dphase], dim=axis) / _PI


def frame_signal(wave: torch.Tensor, frame_length: int,
                 frame_step: int) -> torch.Tensor:
    """[..., samples] -> [..., frames, frame_length]; the trailing
    remainder is dropped (a strided view, no copy)."""
    return wave.unfold(-1, frame_length, frame_step)


def polar_to_rect(magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """mag * e^{i*phase} as complex64."""
    mag = magnitude.float()
    return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))


def overlap_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
    """[..., frames, frame_length] -> [..., samples] overlap-add.

    When ``frame_step`` divides ``frame_length`` the j-th hop-chunk column
    of all frames is one contiguous run starting at ``j * frame_step``, so
    the sum is ``overlap`` shifted slice-adds; otherwise ``index_add_``.
    """
    num_frames, frame_length = frames.shape[-2], frames.shape[-1]
    samples = (num_frames - 1) * frame_step + frame_length
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (samples,))
    if frame_length % frame_step == 0:
        run = num_frames * frame_step
        for j in range(frame_length // frame_step):
            chunk = frames[..., j * frame_step:(j + 1) * frame_step]
            out[..., j * frame_step:j * frame_step + run] += chunk.reshape(
                lead + (run,)
            )
        return out
    idx = (
        torch.arange(num_frames, device=frames.device)[:, None] * frame_step
        + torch.arange(frame_length, device=frames.device)[None, :]
    ).reshape(-1)
    return out.index_add_(-1, idx, frames.reshape(lead + (-1,)))


def _idft_matrices(config: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real iDFT synthesis matrices [N/2+1, N] with the synthesis window
    folded in: ``frames = Re(S) @ C + Im(S) @ D == irfft(S) * w_synth``
    (Im at DC and Nyquist ignored, as irfft does). float64 -> float32."""
    n = config.frame_length
    bins = config.num_rfft_bins
    k = np.arange(bins)[:, None].astype(np.float64)
    t = np.arange(n)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    coef = np.full((bins, 1), 2.0)
    coef[0, 0] = 1.0
    coef[-1, 0] = 1.0
    c = coef * np.cos(ang) / n
    d = -coef * np.sin(ang) / n
    d[0, :] = 0.0
    d[-1, :] = 0.0
    w = inverse_stft_window(
        hann_window(config.frame_length), config.frame_step
    ).astype(np.float64)
    return (c * w).astype(np.float32), (d * w).astype(np.float32)


def _dft_matrices(config: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real forward-rDFT analysis matrices [N, N/2+1] with the Hann window
    folded in: ``frames @ A + i * (frames @ B) == rfft(frames * hann)``.
    float64 -> float32."""
    n = config.frame_length
    bins = config.num_rfft_bins
    t = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(bins)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    w = hann_window(n).astype(np.float64)[:, None]
    return ((w * np.cos(ang)).astype(np.float32),
            (-w * np.sin(ang)).astype(np.float32))


def _mel_matrices(config: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(linear->mel [F, M], mel->linear pseudo-inverse [M, F]), float32."""
    l2m = linear_to_mel_matrix(
        num_mel_bins=config.num_mel_bins,
        num_spectrogram_bins=config.num_freq_bins,
        sample_rate=config.sample_rate,
        lower_edge_hertz=config.mel_lower_hertz,
        upper_edge_hertz=config.mel_upper_hertz,
    )
    return l2m, mel_to_linear_matrix(l2m)


def constant_cache(build):
    """``functools.lru_cache`` (16 entries) for a builder of constant
    tensors, which runs with torch's dispatch modes and inference mode
    off.

    Under ``torch.export`` every tensor made inside the trace is a fake
    (traced) tensor; cached, it would come back to every later eager call,
    which then computes on tensor subclasses. With the modes off the
    builder makes real tensors, whoever calls first, and a trace takes
    them as constants of its program. With inference mode off, a first
    call from a sampler does not leave inference tensors, which autograd
    refuses to save, to a later caller that records gradients. A hit
    costs what an ``lru_cache`` hit costs.
    """

    @functools.lru_cache(maxsize=16)
    @functools.wraps(build)
    def get(*args):
        with _disable_current_modes(), torch.inference_mode(False):
            return build(*args)

    return get


@constant_cache
def _device_constants(config: AudioConfig, device: torch.device):
    """The float32 constants of the synthesis path on ``device``:
    ``(m2l [M, F], idft_c [N/2+1, N], idft_d [N/2+1, N], window [N])``."""
    _, m2l = _mel_matrices(config)
    c, d = _idft_matrices(config)
    window = inverse_stft_window(hann_window(config.frame_length),
                                 config.frame_step)
    # The kernels index these by raw pointer, so they must be C-contiguous
    # (mel_to_linear_matrix returns a Fortran-ordered array).
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (m2l, c, d, window)
    )


@constant_cache
def _analysis_constants(config: AudioConfig, device: torch.device):
    """The float32 constants of the analysis path on ``device``:
    ``(l2m [F, M], hann [N])``, and the DFT matrices ``(A, B)`` when
    ``config.dft_mode == "matmul"``."""
    l2m, _ = _mel_matrices(config)
    arrays = [l2m, hann_window(config.frame_length)]
    if config.dft_mode == "matmul":
        arrays += list(_dft_matrices(config))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def mel_pinv(config: AudioConfig, device) -> torch.Tensor:
    """The mel pseudo-inverse ``m2l`` [num_mel_bins, num_freq_bins] on
    ``device`` (cached)."""
    return _device_constants(config, torch.device(device))[0]


def stft(wave: torch.Tensor, config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """S1: [..., 64000] wave -> [..., 128, 1024] complex64 spectrogram.

    Pads to ``config.padded_length``, frames, applies the periodic Hann
    window and rFFTs (``dft_mode="fft"``) or multiplies by the windowed
    DFT matrices (``"matmul"``), then drops the DC bin (``discard_dc``) or
    the Nyquist bin.
    """
    if wave.shape[-1] != config.audio_length:
        raise ValueError(
            f"expected waves of {config.audio_length} samples, got "
            f"{wave.shape[-1]} (config.audio_length drives the frame count)"
        )
    wave = torch.nn.functional.pad(wave.float(),
                                   (config.pad_left, config.pad_right))
    frames = frame_signal(wave, config.frame_length, config.frame_step)
    consts = _analysis_constants(config, wave.device)
    if config.dft_mode == "matmul":
        spec = torch.complex(frames @ consts[2], frames @ consts[3])
    elif config.dft_mode == "fft":
        spec = torch.fft.rfft(frames * consts[1], dim=-1)
    else:
        raise ValueError(f"dft_mode {config.dft_mode!r} is not "
                         "'matmul'/'fft'")
    return spec[..., 1:] if config.discard_dc else spec[..., :-1]


def wave_to_specgrams(wave: torch.Tensor,
                      config: AudioConfig = AudioConfig()):
    """wave -> (log-magnitude, IF) on linear frequency bins."""
    spec = stft(wave, config)
    logmag = torch.log(spec.abs() + config.logmel_eps)
    return logmag, instantaneous_frequency(torch.angle(spec), axis=-2)


def specgrams_to_melspecgrams(logmag: torch.Tensor, ifreq: torch.Tensor,
                              config: AudioConfig = AudioConfig()):
    """S8: (log-magnitude, IF) on linear bins -> (log-mel-mag^2, mel-IF).
    The magnitude goes through the mel matrix as power, the phase as the
    accumulated angle, and IF is recomputed after the projection."""
    l2m = _analysis_constants(config, logmag.device)[0]
    mag2 = torch.exp(2.0 * logmag)
    logmelmag2 = torch.log(mag2 @ l2m + config.logmel_eps)
    mel_phase = torch.cumsum(ifreq * _PI, dim=-2) @ l2m
    return logmelmag2, instantaneous_frequency(mel_phase, axis=-2)


def melspecgrams_to_specgrams(logmelmag2: torch.Tensor,
                              mel_ifreq: torch.Tensor,
                              config: AudioConfig = AudioConfig()):
    """S9: the inverse of S8 through the mel pseudo-inverse (lossy)."""
    m2l = mel_pinv(config, logmelmag2.device)
    mag2 = torch.exp(logmelmag2) @ m2l
    logmag = 0.5 * torch.log(torch.clamp(mag2, min=0.0) + config.logmel_eps)
    phase = torch.cumsum(mel_ifreq * _PI, dim=-2) @ m2l
    return logmag, instantaneous_frequency(phase, axis=-2)


def wave_to_melspecgrams(wave: torch.Tensor,
                         config: AudioConfig = AudioConfig()):
    """S11 analysis direction: wave -> (log-mel-mag^2, mel-IF)."""
    return specgrams_to_melspecgrams(*wave_to_specgrams(wave, config), config)


def wave_to_image(wave: torch.Tensor,
                  config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """wave [..., 64000] -> GAN image [..., 128, 1024, 2]: channel 0 the
    log-mel-mag^2 mapped from [logmel_min, logmel_max] to [-1, 1],
    channel 1 the mel-IF."""
    logmelmag2, mel_ifreq = wave_to_melspecgrams(wave, config)
    ch0 = scale(logmelmag2, config.logmel_min, config.logmel_max, -1.0, 1.0)
    return torch.stack([ch0, mel_ifreq], dim=-1)


def istft_rect(re: torch.Tensor, im: torch.Tensor,
               config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Inverse STFT of a spectrum given as (Re, Im) [..., 128, 1024] f32.

    Re-inserts the bin that the analysis dropped (DC under
    ``discard_dc``, else Nyquist), inverse-DFTs each frame (two f32
    matmuls with the window folded in, or ``irfft`` per
    ``config.idft_mode``), overlap-adds and crops the padding off.
    """
    _, c, d, window = _device_constants(config, re.device)
    if config.idft_mode == "matmul":
        # The re-inserted bin is zero, so its row of C / D adds nothing:
        # drop the row instead of padding the spectrum.
        rows = slice(1, None) if config.discard_dc else slice(None, -1)
        frames = re @ c[rows] + im @ d[rows]
    elif config.idft_mode == "fft":
        spec = torch.complex(re, im)
        pad = (1, 0) if config.discard_dc else (0, 1)
        spec = torch.nn.functional.pad(spec, pad)
        frames = torch.fft.irfft(spec, n=config.frame_length, dim=-1) * window
    else:
        raise ValueError(f"idft_mode {config.idft_mode!r} is not "
                         "'matmul'/'fft'")
    wave = overlap_add(frames, config.frame_step)
    return wave[..., config.pad_left:config.pad_left + config.audio_length]


def istft(spec: torch.Tensor, config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """S10 tail: [..., 128, 1024] complex -> [..., 64000] float wave."""
    return istft_rect(spec.real.float(), spec.imag.float(), config)


def specgrams_to_wave(logmag: torch.Tensor, ifreq: torch.Tensor,
                      config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """(log-magnitude, IF) -> wave: phase cumsum, polar -> rect, iSTFT."""
    mag = torch.exp(logmag)
    phase = torch.cumsum(ifreq * _PI, dim=-2)
    return istft_rect(mag * torch.cos(phase), mag * torch.sin(phase), config)


def melspecgrams_to_wave(logmelmag2: torch.Tensor, mel_ifreq: torch.Tensor,
                         config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """S11 synthesis direction: (log-mel-mag^2, mel-IF) -> wave, in the
    reference's simplified form (one cumsum and one mel matmul for the
    phase, ``sqrt(x + eps)`` for the magnitude)."""
    m2l = mel_pinv(config, logmelmag2.device)
    mag2 = torch.exp(logmelmag2) @ m2l
    mag = torch.sqrt(torch.clamp(mag2, min=0.0) + config.logmel_eps)
    phase = torch.cumsum(mel_ifreq * _PI, dim=-2) @ m2l
    return istft_rect(mag * torch.cos(phase), mag * torch.sin(phase), config)


def image_to_wave(image: torch.Tensor,
                  config: AudioConfig = AudioConfig()) -> torch.Tensor:
    """GAN image [..., 128, 1024, 2] f32 -> wave [..., 64000].

    ``synthesis_kernel``: ``"xla"`` takes the plain PyTorch path;
    ``"pallas"`` and ``"auto"`` take the synthesis operator
    (``kernels.synthesis.synthesis_spectrum``), which launches the CUDA
    kernel for a CUDA tensor and runs the plain path for a CPU tensor, so
    a ``torch.export`` trace on either device holds the kernel.
    """
    if image.shape[-1] != 2:
        raise ValueError(
            f"expected a 2-channel (log-mel-mag, mel-IF) image, got "
            f"{image.shape[-1]} channels"
        )
    kern = config.synthesis_kernel
    if kern not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"synthesis_kernel {kern!r} is not one of 'auto'/'xla'/'pallas'"
        )
    if kern != "xla":
        from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum

        lead = image.shape[:-3]
        flat = image.reshape((-1,) + image.shape[-3:]).contiguous()
        re, im = synthesis_spectrum(flat, config)
        wave = istft_rect(re, im, config)
        return wave.reshape(lead + wave.shape[-1:])
    logmelmag2 = scale(image[..., 0], -1.0, 1.0,
                       config.logmel_min, config.logmel_max)
    return melspecgrams_to_wave(logmelmag2, image[..., 1], config)


def spectral_calls(config: AudioConfig, device, graphs: bool = True):
    """``(to_image, to_wave)``: :func:`wave_to_image` and
    :func:`image_to_wave` under ``config`` on ``device``, each one CUDA
    graph a batch size on a card (unless ``graphs`` is False), as the
    reference jits each of them; else eager. The roundtrip's two calls
    (``cli roundtrip``, validate-data's check)."""
    from gansynth_tpu_torch.utils.graphs import on_device

    return (on_device(lambda wave: wave_to_image(wave, config), device,
                      graphs),
            on_device(lambda image: image_to_wave(image, config), device,
                      graphs))
