"""What the synthesis service should answer, plain: note i of a request
with seed s draws its latent from ``key((s * 1000003 + i) & 0x7FFFFFFF)``
(threefry, ``normal`` of ``latent_dim``), the generator renders the
image at the weights' stage (upsampled to the full grid below the final
stage), the synthesis turns it into 64000 samples, and the notes are
concatenated as 16-bit PCM (``int16(clip(w, -1, 1) * 32767)``, the
fraction dropped)."""

from __future__ import annotations

import io
import wave as wavmod
from typing import List, Mapping, Sequence

import numpy as np
import torch

from portbench.reference import nets, spectral, threefry


def note_seeds(seed: int, n: int) -> List[int]:
    return [(int(seed) * 1000003 + i) & 0x7FFFFFFF for i in range(n)]


@torch.no_grad()
def render(cfg: Mapping, params, seeds: Sequence[int],
           pitches: Sequence[int], stage: int, device, q=nets._same,
           block: int = 16) -> np.ndarray:
    """Waves [len(seeds), audio_length] float64, ``block`` notes at a
    time."""
    model, audio = cfg["model"], cfg["audio"]
    out = []
    for i in range(0, len(seeds), block):
        z = torch.from_numpy(threefry.seeded_latents(
            seeds[i:i + block], model["latent_dim"])).to(device)
        labels = nets.onehot(torch.as_tensor(list(pitches[i:i + block]),
                                             device=device), model)
        image = nets.generator(params, z, labels, stage, 1.0, model, q)
        factor = 1 << (model["num_stages"] - 1 - stage)
        if factor > 1:
            image = image.repeat_interleave(factor, 1).repeat_interleave(
                factor, 2)
        out.append(spectral.image_to_wave(image, audio).cpu().numpy())
    return np.concatenate(out)


def pcm(waves: np.ndarray) -> np.ndarray:
    return (np.clip(waves.reshape(-1), -1.0, 1.0) * 32767).astype(np.int16)


def parse_wav(body: bytes, sample_rate: int) -> np.ndarray:
    """The int16 samples of a mono 16-bit WAV at ``sample_rate``; raises
    ValueError for any other body."""
    with wavmod.open(io.BytesIO(body), "rb") as f:
        if (f.getnchannels(), f.getsampwidth(), f.getframerate()) != (
                1, 2, sample_rate):
            raise ValueError("not a mono 16-bit WAV at the sample rate")
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").copy()


def stft_mag(x: np.ndarray, n: int = 1024, hop: int = 256) -> np.ndarray:
    """|STFT| of a 1-D signal (Hann, no padding), float64."""
    x = np.asarray(x, np.float64)
    frames = np.lib.stride_tricks.sliding_window_view(x, n)[::hop]
    return np.abs(np.fft.rfft(frames * np.hanning(n + 1)[:-1], axis=-1))


def note_gaps(served: np.ndarray, ref: np.ndarray, notes: int,
              length: int) -> List[dict]:
    """Per note, the served PCM's relative L2 distance from the
    reference's (``wave``) and its magnitude spectrogram's
    (``spectrum``), each against at least 1 % of full scale. A body of
    the wrong length reads infinity for every note."""
    if served.shape != ref.shape or served.size != notes * length:
        return [{"wave": float("inf"), "spectrum": float("inf")}] * notes
    floor = 0.01 * 32767 * np.sqrt(length)
    out = []
    for i in range(notes):
        s = served[i * length:(i + 1) * length].astype(np.float64)
        r = ref[i * length:(i + 1) * length].astype(np.float64)
        ms, mr = stft_mag(s), stft_mag(r)
        # |STFT| at hop n/4 carries sqrt(1.5) times the wave's norm.
        out.append({
            "wave": float(np.linalg.norm(s - r)
                          / max(np.linalg.norm(r), floor)),
            "spectrum": float(np.linalg.norm(ms - mr)
                              / max(np.linalg.norm(mr),
                                    floor * np.sqrt(1.5)))})
    return out
