"""WaveGAN's cell: its FLOP count by hand, and its two readers, which
read nothing (None, no error) from a program that keeps no critic-update
count or a trace without steps."""

import pytest

from portbench import harness
from portbench.count import wavegan_flops

MODEL = {"wavegan_dim": 64, "latent_dim": 100, "num_pitches": 61}


def test_the_wide_layers_are_838_9_million_multiply_adds_a_note():
    layers = dict(wavegan_flops.generator_layers(MODEL))
    layers.update(wavegan_flops.critic_layers(MODEL))
    wide = [f"upconv_{i}" for i in range(5)] + [f"downconv_{i}"
                                                for i in range(1, 6)]
    for name in wide:
        assert layers[name] / 2 == 16 * 2048 * 1024 * 25   # 838.9 M
    assert layers["upconv_5"] == layers["downconv_0"] == 2 * 16384 * 64 * 25
    assert layers["z_project"] == 2 * 161 * 32768


def test_a_step_at_batch_64_with_5_critic_updates():
    assert wavegan_flops.passes(5) == (8, 62)
    flops = wavegan_flops.train_step_flops(MODEL, 64, 5)
    assert flops == pytest.approx(37.8e12, rel=2e-3)
    per_note = wavegan_flops.critic_flops(MODEL)
    assert per_note == pytest.approx(8.44e9, rel=2e-3)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def test_the_readers_read_nothing_where_there_is_nothing():
    mfu = _reader("train.wavegan_mfu")
    critic = _reader("train.wavegan_critic_update_ms")
    assert mfu({"steps": 0}) is None
    assert critic({}) is None and critic({"phases": {}}) is None
    assert critic({"phases": {"critic_ns": 5, "critic_updates": 0}}) is None
    assert critic({"phases": {"critic_ns": 4e8, "critic_updates": 2}}) == 200
    facts = {"steps": 10, "window_s": 10.0, "model": MODEL, "batch": 64,
             "critic_updates": 5}
    assert mfu(facts) == pytest.approx(
        100 * 37.8e12 / 989e12, rel=2e-3)
