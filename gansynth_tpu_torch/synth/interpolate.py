"""Latent-space interpolation, numpy (a copy of
``gansynth_tpu/synth/interpolate.py``): the timbre-morph path of ``cli
interpolate``.

Two axes morph independently:

- **latent (timbre)**: spherical interpolation (slerp) between two latent
  draws. Gaussian latents concentrate near the shell of radius sqrt(D);
  a straight line cuts through the low-density interior (the midpoint of
  two independent draws has norm ~sqrt(D/2)), where the generator was
  never trained. Slerp follows the great circle, so every point of the
  path keeps a shell-typical norm (White, "Sampling Generative Networks",
  2016).
- **pitch (conditioning)**: the generator conditions on a one-hot pitch
  row; a glide interpolates the label row linearly between two one-hot
  rows.

The path is a [N, D] batch rendered by one call of the port's
``make_latent_sampler``.
"""

from __future__ import annotations

import numpy as np


def slerp(za: np.ndarray, zb: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation between latent vectors ``za``, ``zb`` [D].

    ``t`` is scalar or [N]; returns [D] or [N, D]. Follows the great
    circle through the two points (interpolating the angle; the radius
    interpolates implicitly between ``|za|`` and ``|zb|``):

        slerp(a, b, t) = sin((1-t)w)/sin(w) * a + sin(t*w)/sin(w) * b

    with ``w`` the angle between a and b. Falls back to linear
    interpolation when the vectors are (anti)parallel enough that
    ``sin(w)`` loses precision — there the chord and the arc coincide
    (or, for antiparallel vectors, the great circle is degenerate and
    lerp is the only continuous choice).
    """
    za = np.asarray(za, np.float64)
    zb = np.asarray(zb, np.float64)
    t = np.asarray(t, np.float64)[..., None]  # broadcast over D
    na = np.linalg.norm(za)
    nb = np.linalg.norm(zb)
    if na == 0.0 or nb == 0.0:  # degenerate endpoint: angle undefined
        out = (1.0 - t) * za + t * zb
        return out.astype(np.float32)
    cos_w = np.clip(np.dot(za / na, zb / nb), -1.0, 1.0)
    w = np.arccos(cos_w)
    sin_w = np.sin(w)
    if sin_w < 1e-6:
        out = (1.0 - t) * za + t * zb
    else:
        out = (np.sin((1.0 - t) * w) * za + np.sin(t * w) * zb) / sin_w
    return out.astype(np.float32)


def interpolation_latents(
    za: np.ndarray, zb: np.ndarray, steps: int, mode: str = "slerp"
) -> np.ndarray:
    """[steps, D] latent path from ``za`` to ``zb`` inclusive."""
    if steps < 2:
        raise ValueError("an interpolation path needs >= 2 steps")
    t = np.linspace(0.0, 1.0, steps)
    if mode == "slerp":
        return slerp(za, zb, t)
    if mode == "lerp":
        out = (1.0 - t[:, None]) * np.asarray(za, np.float64) + t[
            :, None
        ] * np.asarray(zb, np.float64)
        return out.astype(np.float32)
    raise ValueError(f"unknown interpolation mode {mode!r}")


def interpolation_labels(
    pitch_a: int, pitch_b: int, steps: int, pitch_min: int, num_pitches: int
) -> np.ndarray:
    """[steps, num_pitches] label path: one-hot(a) -> one-hot(b) linearly.

    ``pitch_a == pitch_b`` yields the constant one-hot row (pure timbre
    morph at fixed pitch).
    """
    def onehot(p: int) -> np.ndarray:
        idx = min(max(int(p) - pitch_min, 0), num_pitches - 1)
        row = np.zeros((num_pitches,), np.float32)
        row[idx] = 1.0
        return row

    t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
    return (1.0 - t) * onehot(pitch_a) + t * onehot(pitch_b)


def crossfade_concat(
    waves: np.ndarray, overlap: int
) -> np.ndarray:
    """Join [N, L] note waveforms into one stream with ``overlap``-sample
    equal-power crossfades (cos/sin ramps, unit summed power) — the
    rendered "morph" artifact. Output length ``N*L - (N-1)*overlap``.

    ``overlap == 0`` is plain concatenation. Equal-power is the right
    fade law here: adjacent path notes are decorrelated enough (different
    latents) that constant summed *power*, not amplitude, keeps loudness
    steady through the seam.
    """
    waves = np.asarray(waves, np.float32)
    n, length = waves.shape
    if not 0 <= overlap <= length:
        raise ValueError(f"overlap {overlap} outside [0, {length}]")
    if n == 1 or overlap == 0:
        return waves.reshape(-1) if overlap == 0 else waves[0]
    theta = np.linspace(0.0, np.pi / 2, overlap, dtype=np.float32)
    fade_out = np.cos(theta)
    fade_in = np.sin(theta)
    out = np.zeros((n * length - (n - 1) * overlap,), np.float32)
    pos = 0
    for i, w in enumerate(waves):
        w = w.copy()
        if i > 0:
            w[:overlap] *= fade_in
        if i < n - 1:
            w[length - overlap:] *= fade_out
        out[pos:pos + length] += w
        pos += length - overlap
    return out
