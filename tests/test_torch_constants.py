"""The port's copied constant builders and config against the reference.

The windows, mel matrices and iDFT matrices are built in numpy float64
and stored float32 by both packages; the copies must be bitwise equal.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

from gansynth_tpu.ops import mel as jmel
from gansynth_tpu.ops import spectral as jspec
from gansynth_tpu.ops import windows as jwin
from gansynth_tpu.utils import config as jcfg
from gansynth_tpu_torch.ops import mel as tmel
from gansynth_tpu_torch.ops import spectral as tspec
from gansynth_tpu_torch.ops import windows as twin
from gansynth_tpu_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("length", [16, 512, 2048])
def test_hann_window_bitwise(length):
    np.testing.assert_array_equal(twin.hann_window(length),
                                  jwin.hann_window(length))


@pytest.mark.parametrize("length,step", [(2048, 512), (16, 4), (12, 6)])
def test_inverse_stft_window_bitwise(length, step):
    np.testing.assert_array_equal(
        twin.inverse_stft_window(twin.hann_window(length), step),
        jwin.inverse_stft_window(jwin.hann_window(length), step),
    )


@pytest.mark.parametrize("mels,bins", [(1024, 1024), (64, 128)])
def test_mel_matrices_bitwise(mels, bins):
    l2m_t = tmel.linear_to_mel_matrix(mels, bins)
    l2m_j = jmel.linear_to_mel_matrix(mels, bins)
    np.testing.assert_array_equal(l2m_t, l2m_j)
    np.testing.assert_array_equal(tmel.mel_to_linear_matrix(l2m_t),
                                  jmel.mel_to_linear_matrix(l2m_j))


def test_spectral_constants_bitwise():
    cfg = jcfg.AudioConfig()
    for got, want in zip(tspec._idft_matrices(tcfg.AudioConfig()),
                         jspec._idft_matrices(cfg)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(tspec._mel_matrices(tcfg.AudioConfig()),
                         jspec._mel_matrices(cfg)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_config_is_a_verbatim_copy():
    """The port's config is the reference's, letter for letter, outside
    its blocks marked port only (the WaveGAN fields, which the reference
    lacks), and those blocks hold only the fields ``PORT_ONLY`` lists."""
    with open(os.path.join(ROOT, "gansynth_tpu", "utils", "config.py")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "gansynth_tpu_torch", "utils",
                           "config.py")) as f:
        port = f.read()
    block = r"(\n\n)?[ ]*# --- port only.*?# --- end port only ---\n"
    assert re.sub(block, "", port, flags=re.S) == ref
    for section, keys in tcfg.PORT_ONLY.items():
        ref_fields = {f.name for f in dataclasses.fields(
            getattr(jcfg.Config(), section))}
        port_fields = {f.name for f in dataclasses.fields(
            getattr(tcfg.Config(), section))}
        assert port_fields - ref_fields == set(keys)


def test_flagship_config_loads_unchanged():
    import json

    with open(os.path.join(ROOT, "runs", "flagship_r4",
                           "train_config.json")) as f:
        raw = json.load(f)
    port = tcfg.Config().with_overrides(raw)
    ref = jcfg.Config().with_overrides(raw)
    assert tcfg.as_dict(port) == dataclasses.asdict(ref)
    assert port.model.compute_dtype == "bfloat16"
    assert port.audio.synthesis_kernel == "auto"
    assert tcfg.scale(0.5, -1.0, 1.0, -14.0, 14.0) == jcfg.scale(
        0.5, -1.0, 1.0, -14.0, 14.0)


def test_device_constants_are_c_contiguous():
    """The CUDA kernels read m2l and the iDFT matrices by raw pointer;
    the numpy builder returns m2l in Fortran order, so the cached device
    copies must be made C-contiguous."""
    import torch

    consts = tspec._device_constants(tcfg.AudioConfig(), torch.device("cpu"))
    assert all(t.is_contiguous() for t in consts)
    np.testing.assert_array_equal(consts[0].numpy(),
                                  tspec._mel_matrices(tcfg.AudioConfig())[1])
