"""Synthetic notes for smoke runs (``gansynth_tpu/data/fixtures.py``).

``midi_to_hz`` and ``synthesize_note`` copied as numpy: a harmonic stack at
a MIDI pitch with an exponential decay, so a training step has real waves
without a dataset. :func:`note_batch` spreads such notes over a pitch
range.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def midi_to_hz(pitch) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(pitch, dtype=np.float64) - 69.0) / 12.0)


def synthesize_note(
    pitch: int,
    *,
    sample_rate: int = 16000,
    length: int = 64000,
    num_harmonics: int = 4,
    decay: float = 1.5,
    seed: Optional[int] = None,
) -> np.ndarray:
    """One note: harmonic stack at the MIDI pitch with exponential decay."""
    rng = np.random.default_rng(pitch if seed is None else seed)
    t = np.arange(length) / sample_rate
    f0 = float(midi_to_hz(pitch))
    wave = np.zeros(length)
    for h in range(1, num_harmonics + 1):
        if f0 * h >= sample_rate / 2:
            break
        amp = 1.0 / h * (0.8 + 0.4 * rng.random())
        wave += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    wave *= np.exp(-t * decay)
    wave /= max(np.abs(wave).max(), 1e-9)
    return (0.9 * wave).astype(np.float32)


def note_batch(batch: int, pitch_min: int = 24, pitch_max: int = 84):
    """``(waves [batch, 64000] f32, pitches [batch] int64)``: one note per
    pitch, the pitches spread evenly over ``[pitch_min, pitch_max]``."""
    pitches = np.linspace(pitch_min, pitch_max, batch).round().astype(
        np.int64)
    waves = np.stack([synthesize_note(int(p), seed=i)
                      for i, p in enumerate(pitches)])
    return waves, pitches
