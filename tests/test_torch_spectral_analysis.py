"""The analysis direction of the port's spectral library against the
reference's (wave -> STFT -> log-magnitude and IF -> mel -> image).

Inputs are numpy tones (plus a little seeded noise) handed to both
packages. The tolerances are those of ``tests/test_spectral.py``: 1e-6
for elementwise phase ops, 1e-3 for unwrap and IF, 2e-3 for the STFT and
the image's magnitude channel. The FFT libraries differ in the last bits
(7e-5 of a 479 peak here), so the phase of a bin with next to no energy
is noise on both sides: IF is held at 1e-3 only where both frames of a
bin carry at least 1e-3 of the peak magnitude, and elsewhere may wrap to
the other side of +-pi in under 1% of the elements.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.ops import spectral as js
from gansynth_tpu.utils.config import AudioConfig as JAudio
from gansynth_tpu_torch.ops import spectral as ts
from gansynth_tpu_torch.utils.config import AudioConfig as TAudio


def _tone(freqs, amps, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(64000) / 16000
    w = sum(a * np.sin(2 * np.pi * f * t) for f, a in zip(freqs, amps))
    w = w / max(1.0, np.abs(w).max()) + 0.001 * rng.standard_normal(64000)
    return w.astype(np.float32)


WAVES = np.stack([_tone([329.6, 659.2], [1.0, 0.4], 0),
                  _tone([440.0], [1.0], 1)])


def _j(x):
    return np.array(x)


def test_diff_and_frame_signal():
    x = np.random.default_rng(2).standard_normal((3, 100)).astype(np.float32)
    np.testing.assert_allclose(ts.diff(torch.from_numpy(x), -1).numpy(),
                               _j(js.diff(jnp.asarray(x), -1)), atol=1e-6)
    np.testing.assert_array_equal(
        ts.frame_signal(torch.from_numpy(x), 16, 4).numpy(),
        _j(js.frame_signal(jnp.asarray(x), 16, 4)))


def test_unwrap_matches_reference_and_numpy():
    rng = np.random.default_rng(3)
    ramp = np.cumsum(rng.uniform(-2.5, 2.5, size=(4, 128, 8)), axis=1)
    wrapped = np.angle(np.exp(1j * ramp)).astype(np.float32)
    ours = ts.unwrap(torch.from_numpy(wrapped), axis=-2).numpy()
    np.testing.assert_allclose(
        ours, _j(js.unwrap(jnp.asarray(wrapped), axis=-2)), atol=1e-3)
    np.testing.assert_allclose(
        ours, np.unwrap(wrapped.astype(np.float64), axis=-2), atol=1e-3)


def test_unwrap_tie_break():
    """A jump of exactly -pi with a positive raw difference maps to +pi
    (numpy's tie-break, ``spectral.py:73-76``); floor mod, not fmod."""
    pi = np.float32(np.pi)
    phase = np.array([[0.0], [pi], [2 * pi], [-pi], [pi / 2]],
                     dtype=np.float32)
    ours = ts.unwrap(torch.from_numpy(phase), axis=-2).numpy()
    np.testing.assert_allclose(
        ours, _j(js.unwrap(jnp.asarray(phase), axis=-2)), atol=1e-6)
    ours_if = ts.instantaneous_frequency(torch.from_numpy(phase)).numpy()
    np.testing.assert_allclose(
        ours_if, _j(js.instantaneous_frequency(jnp.asarray(phase))),
        atol=1e-6)


def test_instantaneous_frequency_elementwise():
    phase = np.random.default_rng(4).uniform(
        -np.pi, np.pi, size=(2, 64, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ts.instantaneous_frequency(torch.from_numpy(phase)).numpy(),
        _j(js.instantaneous_frequency(jnp.asarray(phase))), atol=1e-6)


@pytest.mark.parametrize("mode", ["fft", "matmul"])
def test_stft(mode):
    want = _j(js.stft(jnp.asarray(WAVES), JAudio(dft_mode=mode)))
    got = ts.stft(torch.from_numpy(WAVES), TAudio(dft_mode=mode)).numpy()
    assert got.shape == want.shape == (2, 128, 1024)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("mode", ["fft", "matmul"])
def test_wave_to_specgrams(mode):
    jc = JAudio(dft_mode=mode)
    logmag_j, if_j = map(_j, js.wave_to_specgrams(jnp.asarray(WAVES), jc))
    logmag_t, if_t = (t.numpy() for t in ts.wave_to_specgrams(
        torch.from_numpy(WAVES), TAudio(dft_mode=mode)))
    mag = np.abs(_j(js.stft(jnp.asarray(WAVES), jc)))
    live = mag > 1e-3 * mag.max(axis=(-2, -1), keepdims=True)
    live_if = live.copy()
    live_if[:, 1:] &= live[:, :-1]
    assert live_if.sum() > 1000
    np.testing.assert_allclose(logmag_t[live], logmag_j[live], atol=2e-3)
    np.testing.assert_allclose(if_t[live_if], if_j[live_if], atol=1e-3)
    assert np.mean(np.abs(if_t - if_j) > 1e-3) < 0.01


def test_mel_projections_same_inputs():
    """specgrams <-> melspecgrams, both packages fed the reference's
    specgrams: only matmul and cumsum orders differ."""
    jc, tc = JAudio(), TAudio()
    logmag, ifreq = js.wave_to_specgrams(jnp.asarray(WAVES), jc)
    lm_j, mif_j = map(_j, js.specgrams_to_melspecgrams(logmag, ifreq, jc))
    lm_t, mif_t = ts.specgrams_to_melspecgrams(
        torch.from_numpy(_j(logmag)), torch.from_numpy(_j(ifreq)), tc)
    np.testing.assert_allclose(lm_t.numpy(), lm_j, atol=1e-4)
    np.testing.assert_allclose(mif_t.numpy(), mif_j, atol=1e-4)
    back_j = [_j(a) for a in js.melspecgrams_to_specgrams(
        jnp.asarray(lm_j), jnp.asarray(mif_j), jc)]
    back_t = ts.melspecgrams_to_specgrams(
        torch.from_numpy(lm_j), torch.from_numpy(mif_j), tc)
    for a, b in zip(back_t, back_j):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4)
    wave_j = _j(js.specgrams_to_wave(logmag, ifreq, jc))
    wave_t = ts.specgrams_to_wave(torch.from_numpy(_j(logmag)),
                                  torch.from_numpy(_j(ifreq)), tc).numpy()
    np.testing.assert_allclose(wave_t, wave_j, atol=2e-4)


def test_wave_to_image():
    want = _j(js.wave_to_image(jnp.asarray(WAVES), JAudio()))
    got = ts.wave_to_image(torch.from_numpy(WAVES), TAudio()).numpy()
    assert got.shape == want.shape == (2, 128, 1024, 2)
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-3)
    d_if = np.abs(got[..., 1] - want[..., 1])
    assert np.mean(d_if > 1e-3) < 0.01
    assert np.mean(d_if) < 1e-3


def test_config_is_checked():
    with pytest.raises(ValueError, match="samples"):
        ts.stft(torch.zeros(1, 100), TAudio())
    with pytest.raises(ValueError, match="dft_mode"):
        ts.stft(torch.zeros(1, 64000),
                dataclasses.replace(TAudio(), dft_mode="dct"))
