"""The plain reference agrees with the port at a narrow size on the CPU,
piece by piece and through whole runs of the cells (this test imports
both; the reference imports nothing of the port)."""

import math

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import nets, spectral, threefry
from portbench.tests import tiny

SERVE = harness.load_json(harness.HERE / "configs" /
                          "gansynth-mel-hires-serve.json")
MODEL = dict(SERVE["model"], **tiny.TINY_MODEL)
AUDIO = SERVE["audio"]


def _port_config():
    from gansynth_tpu_torch.utils.config import Config

    return Config().with_overrides({"audio": AUDIO, "model": MODEL})


def test_threefry_copy_draws_the_ports_numbers():
    from gansynth_tpu_torch.synth import random as port

    seeds = [0, 1, 2**31 - 1, 123456789]
    assert np.array_equal(threefry.seeded_latents(seeds, 256),
                          port.seeded_latents(seeds, 256))
    key = threefry.split(threefry.seed_to_key(7), 3)[2]
    assert key == tuple(port.split(port.seed_to_key(7), 3)[2])
    k = threefry.fold_in(key, 415000)
    assert np.array_equal(threefry.uniform(k, (8, 1, 1, 1)),
                          port.uniform(k, (8, 1, 1, 1)))
    assert np.array_equal(threefry.permutation(k, 2048),
                          port.permutation(k, 2048))


def test_batch_indices_are_the_ports_stream():
    from gansynth_tpu_torch.train.step import cached_batch_indices
    from portbench.reference import train

    key = train.train_key(99)
    for step in (0, 255, 256, 415001):
        assert np.array_equal(train.batch_indices(key, step, 8, 2048),
                              cached_batch_indices(key, step, 8, 2048))


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(3)
    g = {}
    for name, shape in tiny.generator_shapes(MODEL):
        g[name + "/kernel"] = torch.randn(shape, generator=gen)
        g[name + "/bias"] = 0.02 * torch.randn(shape[-1], generator=gen)
    return g, inputs.critic_params(MODEL, 5, "cpu")


def _port_state(params):
    from gansynth_tpu_torch.utils.checkpoint import from_jax_params

    return from_jax_params({inputs.flax_key(k): v.numpy()
                            for k, v in params.items()})


def test_generator_and_critic_agree(weights):
    from gansynth_tpu_torch.models.discriminator import Discriminator
    from gansynth_tpu_torch.models.generator import Generator

    g_params, d_params = weights
    cfg = _port_config()
    g, d = Generator(cfg.model), Discriminator(cfg.model)
    g.load_state_dict(_port_state(g_params))
    d.load_state_dict(_port_state(d_params))
    z = torch.randn(8, 256, generator=torch.Generator().manual_seed(1))
    labels = nets.onehot(torch.arange(24, 32), MODEL)
    for stage in (0, 2):
        with torch.no_grad():
            ref = nets.generator(g_params, z, labels, stage, 0.7, MODEL)
            got = g(z, labels, stage, 0.7)
            assert torch.allclose(got, ref, atol=2e-5)
            c_ref, l_ref = nets.critic(d_params, ref, stage, 0.7, MODEL)
            c_got, l_got = d(ref, stage, 0.7)
        assert torch.allclose(c_got, c_ref, rtol=1e-4, atol=1e-4)
        assert torch.allclose(l_got, l_ref, rtol=1e-4, atol=1e-4)


def test_frontend_and_synthesis_agree():
    from gansynth_tpu_torch.ops.spectral import image_to_wave, wave_to_image

    cfg = _port_config()
    waves, _ = inputs.make_notes(2, 11, AUDIO, 24, 84, "cpu")
    ref = spectral.wave_to_image(waves, AUDIO)
    got = wave_to_image(waves, cfg.audio)
    assert torch.allclose(got[..., 0], ref[..., 0], atol=1e-5)
    # IF: the port's elementwise form and the reference's unwrapped
    # cumulative sum differ by the sum's rounding.
    assert (got[..., 1] - ref[..., 1]).abs().mean() < 1e-4
    image = torch.tanh(ref)
    w_ref = spectral.image_to_wave(image, AUDIO)
    w_got = image_to_wave(image, cfg.audio).double()
    assert float((w_got - w_ref).norm() / w_ref.norm()) < 1e-4


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_narrow_run_of_each_cell_is_correct(cell, trace, tmp_path):
    result = tiny.run(cell, tmp_path, trace=trace)
    man = harness.manifest(tiny.root_for(cell, tmp_path))
    names = {m["name"] for m in harness.metrics_for(man, cell, trace)}
    assert set(result["metrics"]) <= names
    if trace:
        assert result["device"]["window_s"] > 0
        assert "device_ops" in result["breakdown"]
    assert result["correct"], result["checks"]
    for c in result["checks"].values():
        assert c["value"] < 1e-2 * c["limit"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(math.isfinite(m["value"]) for m in
               result["metrics"].values())
