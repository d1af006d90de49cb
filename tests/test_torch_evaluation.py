"""The port's evaluation (``gansynth_tpu_torch/evaluation.py``) and
interpolation math (``synth/interpolate.py``) against the reference's.

- Every copied numpy function gives the reference's result, bit for bit,
  on the same arrays (they are the same numpy code, so any difference is
  a copying fault). One deliberate difference: ``pitch_attribution``'s
  ``ci95_cepstrum`` is ``None`` where no note has a cepstral pitch (the
  reference reports an interval over no notes).
- The key chain of ``evaluate_sampler`` and ``generate``: ``split`` of
  ``seed_to_key(seed)``, 8 rounds deep, equals ``jax.random``'s.
- ``evaluate_sampler`` end to end on the same tiny weights (seed 0,
  pitches 36/60/84, 2 a pitch, fixture references, attribution): the
  waves within ``WAVE_ATOL`` and ``WAVE_SNR_DB``, then every metric
  within ``EVAL_RTOL``.
- ``tfrecord_reference_fn`` (the port's native reader) serves the
  reference's (``tf.data``) examples per pitch, in the same order, bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gansynth_tpu.evaluation as J
import gansynth_tpu.synth.interpolate as JI
import gansynth_tpu_torch.evaluation as T
import gansynth_tpu_torch.synth.interpolate as TI
import torch_tiny_run as tiny
from gansynth_tpu.synth.sampler import Sampler as JSampler
from gansynth_tpu_torch.data.fixtures import (
    synthesize_note,
    write_synthetic_tfrecords,
)
from gansynth_tpu_torch.synth.random import seed_to_key, split
from gansynth_tpu_torch.synth.sampler import Sampler as TSampler
from torch_threads import two_torch_threads  # noqa: F401

# The port's waves against the reference's on the same weights and keys
# (f32, tiny generator at the final stage, then synthesis; the phase's
# time cumsum carries the generators' rounding differences along a note):
# measured max |diff| 7.1e-4 and SNR 88.4 dB on waves of RMS 1.57.
WAVE_ATOL = 2e-3
WAVE_SNR_DB = 70.0
# Metrics: measured <= 8e-7 relative here; the raw log-spectral and
# Frechet distances read near-silent bins through a log and reached
# 8.5e-5 on the CLI test's run (tests/test_torch_offline_cli.py).
EVAL_RTOL = 1e-3
SR = 16000


def _waves():
    """Pitched fixture notes, a pure tone, an even-only stack, noise and
    near-silence: [10, 64000] float32, and their pitches."""
    rng = np.random.default_rng(3)
    t = np.arange(64000) / SR
    notes = [synthesize_note(p, num_harmonics=nh, decay=dec, seed=s)
             for p, nh, dec, s in ((24, 2, 0.9, 1), (37, 5, 2.1, 2),
                                   (55, 6, 1.4, 3), (60, 4, 1.5, 4),
                                   (84, 3, 1.0, 5), (72, 4, 1.2, 6))]
    f0 = 440.0 * 2 ** ((48 - 69) / 12)
    tone = np.sin(2 * np.pi * f0 * t)
    even = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (2, 4, 6))
    noise = rng.standard_normal(64000) * 0.3
    quiet = rng.standard_normal(64000) * 1e-7
    waves = np.stack(notes + [tone, even, noise, quiet]).astype(np.float32)
    return waves, [24, 37, 55, 60, 84, 72, 48, 48, 60, 36]


def _same(a, b):
    """Equal results: arrays bit for bit (NaN equal to NaN), dicts and
    sequences by their items."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["detect_midi_pitch",
                                  "detect_midi_pitch_cepstrum",
                                  "detect_midi_pitch_acf"])
def test_detectors_equal_the_reference(name):
    waves, _ = _waves()
    got = [getattr(T, name)(w, SR) for w in waves]
    want = [getattr(J, name)(w, SR) for w in waves]
    _same(got, want)
    assert np.isfinite(got[:6]).all()


def test_pitch_accuracy_equals_the_reference():
    waves, pitches = _waves()
    _same(T.pitch_accuracy(waves, pitches, SR),
          J.pitch_accuracy(waves, pitches, SR))


@pytest.mark.parametrize("successes,n", [(0, 0), (0, 5), (3, 7), (122, 122),
                                         (61, 122)])
def test_wilson_interval_equals_the_reference(successes, n):
    _same(T.wilson_interval(successes, n), J.wilson_interval(successes, n))


def test_pitch_attribution_equals_the_reference():
    waves, pitches = _waves()
    got = T.pitch_attribution(waves, pitches, SR)
    assert got["cepstrum_coverage"] > 0
    _same(got, J.pitch_attribution(waves, pitches, SR))


def test_ci95_cepstrum_is_null_without_cepstral_notes():
    """Pure tones have one partial, so no note has a cepstral pitch: the
    port writes ``None`` where the reference writes an interval over no
    notes; every other entry agrees."""
    t = np.arange(64000) / SR
    pitches = [40, 52, 64]
    waves = np.stack([np.sin(2 * np.pi * 440 * 2 ** ((p - 69) / 12) * t)
                      for p in pitches]).astype(np.float32)
    got = T.pitch_attribution(waves, pitches, SR)
    want = J.pitch_attribution(waves, pitches, SR)
    assert got["cepstrum_coverage"] == want["cepstrum_coverage"] == 0.0
    assert got.pop("ci95_cepstrum") is None
    assert want.pop("ci95_cepstrum") is not None
    _same(got, want)


@pytest.mark.parametrize("floor_db", [None, -60.0])
def test_distances_equal_the_reference(floor_db):
    waves, pitches = _waves()
    real, fake = waves[:5], waves[5:]
    _same(T.log_spectral_distance(real, fake, floor_db=floor_db),
          J.log_spectral_distance(real, fake, floor_db=floor_db))
    _same(T.intra_pitch_diversity(waves, pitches, floor_db=floor_db),
          J.intra_pitch_diversity(waves, pitches, floor_db=floor_db))
    fa = T.melspec_features(waves, SR, floor_db=floor_db)
    _same(fa, J.melspec_features(waves, SR, floor_db=floor_db))
    assert fa.shape == (10, 128)
    _same(T.frechet_distance(fa[:5], fa[5:]),
          J.frechet_distance(fa[:5], fa[5:]))


def test_interpolation_math_equals_the_reference():
    rng = np.random.default_rng(0)
    za, zb = rng.standard_normal((2, 16)).astype(np.float32)
    for a, b in ((za, zb), (za, 2 * za), (np.zeros(16, np.float32), zb)):
        _same(TI.slerp(a, b, np.linspace(0, 1, 5)),
              JI.slerp(a, b, np.linspace(0, 1, 5)))
    for mode in ("slerp", "lerp"):
        _same(TI.interpolation_latents(za, zb, 7, mode=mode),
              JI.interpolation_latents(za, zb, 7, mode=mode))
    for a, b in ((60, 60), (36, 72), (10, 99)):
        _same(TI.interpolation_labels(a, b, 5, 24, 61),
              JI.interpolation_labels(a, b, 5, 24, 61))
    waves = rng.standard_normal((4, 1000)).astype(np.float32)
    for overlap in (0, 250, 1000):
        _same(TI.crossfade_concat(waves, overlap),
              JI.crossfade_concat(waves, overlap))
    with pytest.raises(ValueError):
        TI.interpolation_latents(za, zb, 1)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_split_chain_of_eight_equals_jax(seed):
    """``key, sub = split(key)`` eight times from ``seed_to_key(seed)``:
    every ``sub`` equals ``jax.random``'s."""
    key, jkey = seed_to_key(seed), jax.random.key(seed)
    for _ in range(8):
        key, sub = split(key)
        jkey, jsub = jax.random.split(jkey)
        assert sub == tuple(int(w) for w in jax.random.key_data(jsub))
    assert key == tuple(int(w) for w in jax.random.key_data(jkey))


def test_evaluate_sampler_matches_the_reference():
    jcfg, tcfg = tiny.configs()
    params = tiny.tiny_params(seed=1)
    stage = 6
    pitches = [36, 60, 84]
    t_sampler = TSampler(tcfg, tiny.port_generator(params), stage)
    j_sampler = JSampler(jcfg, params, stage=stage)

    # the waves first, round by round along the key chain
    got, got_pitches = T.render_notes(t_sampler, pitches, 2, seed=0)
    key, want = jax.random.key(0), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        want.append(np.asarray(j_sampler(sub, jnp.asarray(pitches))[0]))
    want = np.concatenate(want)
    assert got.shape == want.shape == (6, 64000) and got.dtype == np.float32
    assert got_pitches == pitches * 2
    err = np.abs(got - want)
    assert err.max() < WAVE_ATOL, err.max()
    snr = 10 * np.log10(np.sum(want ** 2) / np.sum(err ** 2))
    assert snr > WAVE_SNR_DB, snr

    kw = dict(pitches=pitches, samples_per_pitch=2, sample_rate=SR, seed=0,
              attribution=True)
    m_t = T.evaluate_sampler(t_sampler, reference_fn=T.fixture_reference_fn(),
                             **kw)
    m_j = J.evaluate_sampler(j_sampler, reference_fn=J.fixture_reference_fn(),
                             **kw)
    assert sorted(m_t) == sorted(m_j)
    assert m_t["num_samples"] == 6.0
    att_t, att_j = m_t.pop("attribution"), m_j.pop("attribution")
    for k, v in m_j.items():
        np.testing.assert_allclose(m_t[k], v, rtol=EVAL_RTOL, err_msg=k)
    assert sorted(att_t) == sorted(att_j)
    for k in ("n", "accuracy_hps", "accuracy_acf", "accuracy_either",
              "failures", "both_failure_modes", "by_region"):
        _same(att_t[k], att_j[k])


def test_tfrecord_reference_fn_serves_the_reference_examples(tmp_path):
    pytest.importorskip("tensorflow")
    path = write_synthetic_tfrecords(
        str(tmp_path / "refs.tfrecord"), num_examples=14,
        pitches=[20, 36, 60, 36, 90, 60, 84], seed=1)
    jcfg, tcfg = tiny.configs()
    t_ref = T.tfrecord_reference_fn([path], tcfg, max_per_pitch=3)
    j_ref = J.tfrecord_reference_fn([path], jcfg, max_per_pitch=3)
    for pitch in (36, 60, 84):
        for index in range(5):
            got, want = t_ref(pitch, index), j_ref(pitch, index)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    for pitch in (20, 90, 48):   # filtered out or absent in both
        for ref in (t_ref, j_ref):
            with pytest.raises(KeyError):
                ref(pitch, 0)
