"""K1, the synthesis-spectrum kernel: its plain version against the TPU
kernel. The CUDA kernel is held to this plain version on a card by
``tests/test_torch_gpu.py`` (no JAX there, so it also runs where JAX is
not installed) and by ``chip_smoke.py``.

Bars are those of ``tests/test_pallas_kernels.py``: spectrum within atol
2e-2 (magnitudes reach ~1e3 and phases ~1e2 rad, so float32 reordering of
the mel matmuls moves Re/Im by up to ~1e-2), and after the iSTFT a wave
max abs error below 5e-3 with an SNR above 40 dB.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.kernels import synthesis_spectrum_pallas
from gansynth_tpu.ops import spectral as jspec
from gansynth_tpu.utils.config import AudioConfig as JAudio
from gansynth_tpu_torch.kernels import launch_counts
from gansynth_tpu_torch.kernels import synthesis as K
from gansynth_tpu_torch.ops import spectral as tspec
from gansynth_tpu_torch.utils.config import AudioConfig as TAudio

JCFG, TCFG = JAudio(), TAudio()


def _wave_bar(want, got):
    err = np.abs(want - got)
    assert err.max() < 5e-3, err.max()
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0, snr


@pytest.fixture(scope="module")
def image():
    t = np.arange(JCFG.audio_length) / JCFG.sample_rate
    wave = np.stack([
        np.sin(2 * np.pi * f * t) * np.exp(-t) for f in (261.6, 440.0)
    ]).astype(np.float32)
    return np.array(jspec.wave_to_image(jnp.asarray(wave), JCFG))


@pytest.fixture(scope="module")
def pallas_spectrum(image):
    re, im = synthesis_spectrum_pallas(jnp.asarray(image), JCFG,
                                       interpret=True)
    return np.array(re), np.array(im)


def test_plain_matches_pallas_interpret(image, pallas_spectrum):
    re, im = K.synthesis_spectrum_plain(torch.from_numpy(image), TCFG)
    assert re.shape == im.shape == (2, 128, 1024)
    np.testing.assert_allclose(re.numpy(), pallas_spectrum[0], atol=2e-2)
    np.testing.assert_allclose(im.numpy(), pallas_spectrum[1], atol=2e-2)


def test_plain_wave_matches_pallas_wave(image, pallas_spectrum):
    want = np.asarray(jspec.istft(
        jnp.asarray(pallas_spectrum[0] + 1j * pallas_spectrum[1]), JCFG))
    re, im = K.synthesis_spectrum_plain(torch.from_numpy(image), TCFG)
    _wave_bar(want, tspec.istft_rect(re, im, TCFG).numpy())


def test_wrapper_takes_plain_version_on_cpu(image):
    x = torch.from_numpy(image)
    before = launch_counts()
    re, im = K.synthesis_spectrum(x, TCFG)
    plain = K.synthesis_spectrum_plain(x, TCFG)
    torch.testing.assert_close(re, plain[0], rtol=0, atol=0)
    torch.testing.assert_close(im, plain[1], rtol=0, atol=0)
    assert launch_counts() == before  # no kernel launched


@pytest.mark.parametrize("bad", ["dtype", "rank", "frames", "channels",
                                 "contiguous", "bins"])
def test_wrapper_rejects_what_the_kernel_does_not_take(image, bad):
    x = torch.from_numpy(image)
    cfg = TCFG
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "frames":
        x = x[:, :64]
    elif bad == "channels":
        x = torch.cat([x, x[..., :1]], dim=-1)
    elif bad == "contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        cfg = dataclasses.replace(TCFG, num_freq_bins=512)
    with pytest.raises((TypeError, ValueError)):
        K.synthesis_spectrum(x, cfg)
