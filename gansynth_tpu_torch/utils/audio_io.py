"""Minimal WAV writing (stdlib only) for the generate/roundtrip paths.

A copy of ``gansynth_tpu/utils/audio_io.py``, which imports no JAX.
"""

from __future__ import annotations

import wave as _wave

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000) -> str:
    """Write mono float audio in [-1, 1] as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with _wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
    return path


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with _wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        pcm = np.frombuffer(f.readframes(n), dtype=np.int16)
    return pcm.astype(np.float32) / 32767.0, sr
