"""K1's tap tables and the kernel's arithmetic, on the CPU.

The CUDA kernel (``kernels/csrc/synthesis_spectrum.cu``) never multiplies
by the dense mel pseudo-inverse m2l: it gathers each linear bin's <= 2
nonzeros from ``tap_tables`` within the mel span that ``strip_spans``
gives its block. Here the tables are held to the JAX package's m2l, and a
tensor emulation of the kernel's arithmetic, in the kernel's order (fma
for the un-scale, a frame-by-frame float32 running sum for the phase, the
taps in ascending mel order as fmaf(E1, w1, E0 * w0)), is held to the TPU
kernel run in interpret mode at the bars of
``tests/test_torch_synthesis_kernel.py``: spectrum within atol 2e-2, wave
max abs error below 5e-3 with an SNR above 40 dB. The emulation lives in
this file only; the port's CUDA path is the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.kernels import synthesis_spectrum_pallas
from gansynth_tpu.ops import mel as jmel
from gansynth_tpu.ops import spectral as jspec
from gansynth_tpu.utils.config import AudioConfig as JAudio
from gansynth_tpu_torch.kernels import synthesis as K
from gansynth_tpu_torch.ops import spectral as tspec
from gansynth_tpu_torch.utils.config import AudioConfig as TAudio

JCFG, TCFG = JAudio(), TAudio()


def _reference_m2l():
    """The JAX package's mel pseudo-inverse, as its kernel builds it
    (Fortran-ordered, as ``mel_to_linear_matrix`` returns it)."""
    l2m = jmel.linear_to_mel_matrix(
        num_mel_bins=JCFG.num_mel_bins,
        num_spectrogram_bins=JCFG.num_freq_bins,
        sample_rate=JCFG.sample_rate,
        lower_edge_hertz=JCFG.mel_lower_hertz,
        upper_edge_hertz=JCFG.mel_upper_hertz,
    )
    return jmel.mel_to_linear_matrix(l2m)


@pytest.fixture(scope="module")
def m2l():
    return _reference_m2l()


@pytest.fixture(scope="module")
def taps():
    return K.tap_tables(K.mel_pinv(TCFG, "cpu").numpy())


def _scatter(index, weight, shape):
    out = np.zeros(shape, dtype=np.float32)
    f, k = np.nonzero(index >= 0)
    out[index[f, k], f] = weight[f, k]
    return out


def test_tap_tables_rebuild_the_reference_m2l_bit_for_bit(m2l, taps):
    index, weight = taps
    rebuilt = _scatter(index, weight, m2l.shape)
    assert np.array_equal(rebuilt.view(np.uint32),
                          np.ascontiguousarray(m2l).view(np.uint32))
    # the padding carries nothing
    assert np.all(weight[index < 0] == 0)


def test_tap_counts_order_and_layout(taps):
    index, weight = taps
    assert index.shape == weight.shape == (TCFG.num_freq_bins, K.TAPS) \
        == (1024, 2)
    assert index.dtype == np.int32 and weight.dtype == np.float32
    assert index.flags["C_CONTIGUOUS"] and weight.flags["C_CONTIGUOUS"]
    counts = (index >= 0).sum(axis=1)
    assert np.bincount(counts, minlength=3).tolist() == [2, 2, 1020]
    # taps first, padding after; two taps ascending in mel
    assert np.all((index[:, 0] >= 0) | (index[:, 1] < 0))
    two = counts == 2
    assert np.all(index[two, 0] < index[two, 1])
    assert np.all(weight[index >= 0] != 0)


@pytest.mark.parametrize("order", ["C", "F"])
def test_tap_tables_are_c_contiguous_whatever_the_input_order(m2l, taps,
                                                              order):
    arr = np.asarray(m2l, order=order)
    assert arr.flags[f"{order}_CONTIGUOUS"]
    index, weight = K.tap_tables(arr)
    assert index.flags["C_CONTIGUOUS"] and weight.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(index, taps[0])
    np.testing.assert_array_equal(weight, taps[1])


def test_tap_tables_refuse_a_column_with_too_many_nonzeros(m2l):
    crowded = np.array(m2l, dtype=np.float32)
    assert np.count_nonzero(crowded[:, 500]) == 2
    crowded[0, 500] = 0.25                # a third nonzero, first in mel
    with pytest.raises(ValueError, match="column 500 .* 3 nonzeros"):
        K.tap_tables(crowded)


def test_strip_spans_hold_every_tap_of_their_strip(taps):
    index, _ = taps
    spans = K.strip_spans(index)
    assert spans.shape == (TCFG.num_freq_bins // K.STRIP, 2)
    assert spans.dtype == np.int32 and spans.flags["C_CONTIGUOUS"]
    lo, width = spans[:, 0], spans[:, 1]
    assert np.all(lo % 2 == 0) and np.all(width % 2 == 0)
    assert np.all(lo >= 0) and np.all(lo + width <= TCFG.num_mel_bins)
    for s, (m_lo, span) in enumerate(spans):
        used = index[s * K.STRIP:(s + 1) * K.STRIP]
        used = used[used >= 0]
        assert used.min() >= m_lo and used.max() < m_lo + span
        assert span - (used.max() + 1 - used.min()) <= 2   # rounding only
    # the widest span sets the kernel's shared memory: 128 x 62 x 8 bytes
    assert width.max() == 62


def test_strip_spans_refuse_a_ragged_strip(taps):
    with pytest.raises(ValueError, match="strips"):
        K.strip_spans(taps[0][:1000])


def test_device_tables_on_the_cpu(taps):
    index, weight, strips, span_max = K._device_taps(TCFG,
                                                     torch.device("cpu"))
    assert index.dtype == torch.int32 and weight.dtype == torch.float32
    assert strips.dtype == torch.int32 and span_max == 62
    assert all(t.is_contiguous() for t in (index, weight, strips))
    np.testing.assert_array_equal(index.numpy(), taps[0])
    np.testing.assert_array_equal(weight.numpy(), taps[1])


def _fma(x, y, z):
    """float32 fmaf emulated in float64 (the product is exact there)."""
    return (x.double() * y.double() + z.double()).float()


def kernel_emulation(image: np.ndarray, config: TAudio):
    """The CUDA kernel's arithmetic, step for step, in tensors."""
    index, weight = K.tap_tables(K.mel_pinv(config, "cpu").numpy())
    x = torch.from_numpy(image)
    a = (config.logmel_max - config.logmel_min) / 2.0
    b = (config.logmel_max + config.logmel_min) / 2.0
    e = torch.exp(_fma(x[..., 0], torch.tensor(a), torch.tensor(b)))
    v = x[..., 1] * torch.tensor(np.float32(np.pi))
    p = torch.empty_like(v)
    phase = torch.zeros_like(v[:, 0])
    for t in range(v.shape[1]):          # frame by frame, float32
        phase = phase + v[:, t]
        p[:, t] = phase
    idx = torch.from_numpy(index).long()
    w = torch.from_numpy(weight)
    has = idx >= 0
    i0, i1 = idx[:, 0].clamp(min=0), idx[:, 1].clamp(min=0)
    zero = torch.zeros(())
    mag2 = torch.where(has[:, 0], e[..., i0] * w[:, 0], zero)
    phi = torch.where(has[:, 0], p[..., i0] * w[:, 0], zero)
    mag2 = torch.where(has[:, 1], _fma(e[..., i1], w[:, 1], mag2), mag2)
    phi = torch.where(has[:, 1], _fma(p[..., i1], w[:, 1], phi), phi)
    mag = torch.sqrt(torch.clamp(mag2, min=0.0) + config.logmel_eps)
    return mag * torch.cos(phi), mag * torch.sin(phi)


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


@pytest.fixture(scope="module")
def emulated(image):
    return kernel_emulation(image, TCFG)


@pytest.mark.parametrize("part", [0, 1], ids=["re", "im"])
def test_kernel_order_matches_pallas_interpret(emulated, pallas_spectrum,
                                               part):
    got = emulated[part].numpy()
    assert got.shape == (2, 128, 1024)
    np.testing.assert_allclose(got, pallas_spectrum[part], atol=2e-2)


def test_kernel_order_wave_matches_pallas_wave(emulated, pallas_spectrum):
    want = np.asarray(jspec.istft(
        jnp.asarray(pallas_spectrum[0] + 1j * pallas_spectrum[1]), JCFG))
    got = tspec.istft_rect(emulated[0], emulated[1], TCFG).numpy()
    err = np.abs(want - got)
    assert err.max() < 5e-3, err.max()
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0, snr


def test_kernel_order_without_taps_gives_sqrt_eps(emulated):
    """Bins 0 and 1023 have no taps: mag = sqrt(eps), phase 0, as the
    dense form gives."""
    re, im = emulated
    want = np.sqrt(np.float32(TCFG.logmel_eps))
    for f in (0, 1023):
        np.testing.assert_allclose(re[..., f].numpy(), want, rtol=1e-6)
        assert torch.all(im[..., f] == 0)
