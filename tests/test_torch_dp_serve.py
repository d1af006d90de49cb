"""Data-parallel serving on the CPU: ``synth/sampler.py:
make_dp_seeded_sampler`` / ``make_dp_sampler`` and ``SynthesisService(...,
devices=...)``, with a list of repeated ``cpu`` devices standing in for
the reference's 8 virtual CPU devices.

- Each device renders its share of the batch as the in-process sampler
  renders those notes at the share's batch size, to the bit, and the waves
  come back in batch order; the reference's DP sampler on the conftest's
  8-device mesh renders the same notes within the repo's synthesis bar
  (max abs error < 5e-3, SNR > 40 dB).
- The service rounds ``max_batch`` up to a multiple of the device count
  and builds every rung as one, as the reference's does under a mesh; a
  served request's waves are the DP sampler's at its rung.
- ``serve --from-exported`` with ``--data-parallel`` exits 2 with the
  reference's message, as does a service given both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tiny_run as tiny
from gansynth_tpu.parallel import make_mesh
from gansynth_tpu.synth.sampler import make_dp_seeded_sampler as j_dp_seeded
from gansynth_tpu_torch import cli
from gansynth_tpu_torch.serve import SynthesisService, batch_ladder
from gansynth_tpu_torch.synth.random import fold_in, normal, seed_to_key
from gansynth_tpu_torch.synth.sampler import (
    make_dp_sampler,
    make_dp_seeded_sampler,
    make_latent_sampler,
    make_seeded_sampler,
    pitch_to_onehot,
)
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

STAGE = 1
SEEDS = [5, 17, 2 ** 31 - 2, 0, 9, 123, 77, 4]
PITCHES = [24, 36, 48, 60, 72, 84, 55, 67]


@pytest.fixture(scope="module")
def model():
    params = tiny.tiny_params()
    _, config = tiny.configs()
    return params, config, tiny.port_generator(params, config)


@pytest.mark.parametrize("n,batch", [(2, 4), (4, 8)])
def test_dp_seeded_sampler_renders_each_share_as_the_sampler(model, n,
                                                              batch):
    _, config, g = model
    got = make_dp_seeded_sampler(config, g, ["cpu"] * n, STAGE)(
        SEEDS[:batch], PITCHES[:batch])
    one = make_seeded_sampler(config, g, STAGE)
    per = batch // n
    want = torch.cat([one(SEEDS[i:i + per], PITCHES[i:i + per])
                      for i in range(0, batch, per)])
    assert got.device.type == "cpu" and got.shape == (batch, 64000)
    assert torch.equal(got, want.float())


def test_dp_keyed_sampler_renders_each_share_as_the_latent_sampler(model):
    _, config, g = model
    key = fold_in(seed_to_key(3), 415000)
    got = make_dp_sampler(config, g, ["cpu", "cpu"], STAGE)(key, PITCHES[:4])
    z = normal(key, (4, config.model.latent_dim))
    labels = pitch_to_onehot(torch.tensor(PITCHES[:4]), config)
    latent = make_latent_sampler(config, g, STAGE)
    want = torch.cat([latent(z[i:i + 2], labels[i:i + 2])[0]
                      for i in (0, 2)])
    assert torch.equal(got, want.float())


def test_dp_seeded_sampler_matches_the_references_mesh(model):
    params, config, g = model
    jcfg, _ = tiny.configs()
    want = np.asarray(j_dp_seeded(jcfg, make_mesh(), STAGE)(
        params, jnp.asarray(SEEDS, jnp.int32),
        jnp.asarray(PITCHES, jnp.int32)))
    got = make_dp_seeded_sampler(config, g, ["cpu"] * 4, STAGE)(
        SEEDS, PITCHES).numpy()
    err = np.abs(want - got)
    assert err.max() < 5e-3
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0


def test_replicas_are_copies(model):
    """Each device holds its own replica: the service's weights do not
    follow later changes to the generator it was made from."""
    _, config, g = model
    sample = make_dp_seeded_sampler(config, g, ["cpu", "cpu"], STAGE)
    before = sample(SEEDS[:2], PITCHES[:2])
    backup = {k: v.clone() for k, v in g.state_dict().items()}
    with torch.no_grad():
        for p in g.parameters():
            p.add_(1.0)
    try:
        assert torch.equal(sample(SEEDS[:2], PITCHES[:2]), before)
    finally:
        g.load_state_dict(backup)


@pytest.mark.parametrize("devices,max_batch,rungs", [
    (2, 5, (2, 6)), (3, 16, (3, 12, 18)), (1, 16, (1, 4, 16))])
def test_rungs_are_multiples_of_the_devices(devices, max_batch, rungs):
    assert batch_ladder(-(-max_batch // devices) * devices, devices) == rungs


def test_service_rounds_its_rungs_and_serves_the_dp_sampler(model):
    _, config, g = model
    service = SynthesisService(config, g, stage=STAGE, max_batch=3,
                               devices=["cpu", "cpu"],
                               request_timeout_s=120.0)
    try:
        assert service.max_batch == 4 and service.batch_ladder == (2, 4)
        health = service.health()
        assert health["mesh_devices"] == 2
        assert health["determinism"] == "per-rung-per-mesh"
        got = service.synthesize([48, 60, 72], seed=11)
        seeds = [(11 * 1000003 + i) & 0x7FFFFFFF for i in range(3)]
        want = make_dp_seeded_sampler(config, g, ["cpu", "cpu"], STAGE)(
            seeds + [0], [48, 60, 72, config.model.pitch_min])[:3]
        np.testing.assert_array_equal(got, want.numpy())
    finally:
        service.close()


def test_exported_artifact_does_not_take_data_parallel(model, capsys):
    """The reference's refusal (``gansynth_tpu/cli.py:613-617``), before
    the artifact is read."""
    assert cli.main(["serve", "--from-exported", "missing.gsx",
                     "--data-parallel", "--device", "cpu"]) == 2
    assert "does not compose with --data-parallel" in \
        capsys.readouterr().err
    _, config, g = model

    class Artifact:
        meta = {"batch": "symbolic"}
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="single lowered program"):
        SynthesisService(config, None, exported=Artifact(),
                         devices=["cpu", "cpu"])


def test_serve_data_parallel_on_the_cpu_holds_one_replica(tmp_path, model):
    """``serve --data-parallel --device cpu``: every visible card on CUDA;
    on the CPU one replica, the rungs of one device."""
    params, _, _ = model
    run = tiny.make_run(str(tmp_path / "run"), params, stage=STAGE)
    args = cli.build_parser().parse_args(
        ["serve", "--model-dir", run, "--data-parallel", "--device", "cpu",
         "--max-batch", "4"])
    service, message = cli.make_service(args)
    try:
        assert service.devices == [torch.device("cpu")]
        assert service.batch_ladder == (1, 4)
        assert "1 device(s)" in message
    finally:
        service.close()
