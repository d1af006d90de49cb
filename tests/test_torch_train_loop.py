"""The port's training loop (``train/loop.py``) against the reference's.

A 2-stage ladder at a narrow width (stage 0 for 3 steps, then stage 1's
4-step fade), unroll 3, the anchor released at step 8, over a
``device_dataset`` of 16 fixture notes, 12 steps: the chunks are clamped
at the stage change and at the release step ([0,3) [3,6) [6,8) [8,11)
[11,12)).

- The port logs the reference's steps, stages and alphas, checkpoints at
  the reference's steps and writes ``ema.npz`` with its step and stage
  (the values differ: the two frontends differ in near-silent bins, and
  the step's own parity is ``test_torch_superstep.py``'s).
- A run resumed from its checkpoint at step 7 (inside a chunk of the
  unbroken run) ends bit-equal to the unbroken run; so do runs resumed
  through the ``data_iter`` route (fast-forward by ``step -
  data_position``) and the ``data_factory`` route (each stage's stream
  built at the step's place within its stage).
- A STOP file present at start is honoured at the first boundary:
  checkpoint, file consumed, return.
- The keyed sampler of the sample dumps draws the reference's notes.
- The reference's mesh arguments run: a one-rank mesh and either cache
  layout equal the plain loop to the bit (the multi-rank loop is
  ``test_torch_parallel.py``'s); ``use_mesh`` without a process group
  raises; a resume refuses a newest checkpoint that only the reference
  saved (orbax).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.synth.sampler import make_sampler as j_make_sampler
from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.train.loop import train as j_train
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.data.fixtures import note_batch
from gansynth_tpu_torch.synth import random as R
from gansynth_tpu_torch.synth.sampler import make_sampler
from gansynth_tpu_torch.train.loop import train
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.utils.checkpoint import Checkpointer, from_jax_params
from gansynth_tpu_torch.utils.config import Config
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

OVERRIDES = {
    "model": dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8),
    "train": dict(batch_size=2, stage_fade_steps=[0, 4, 4, 4, 4, 4, 4],
                  stage_stable_steps=[3, 6, 4, 4, 4, 4, 4], unroll=3,
                  checkpoint_every=4, log_every=2, sample_every=0,
                  pitch_consistency_weight=1.0,
                  pitch_consistency_min_stage=1,
                  pitch_consistency_release_step=8),
}
STEPS = 12


@pytest.fixture(scope="module")
def dataset():
    waves, pitches = note_batch(16)
    return waves, pitches.astype(np.int32)


def _config(**train):
    return Config().with_overrides(OVERRIDES).with_overrides(
        {"train": train})


def _logged(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(r["step"], r["stage"], r["alpha"]) for r in map(json.loads, f)]


def _ema_meta(workdir):
    with np.load(os.path.join(workdir, "ema.npz")) as z:
        return int(z["__step__"]), int(z["__stage__"])


def _bits(state):
    out = {"step": state.step, "rng": state.rng,
           "count": (state.g_opt.count, state.d_opt.count)}
    for name in ("g", "d", "ema"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.clone()
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                out[f"{name}.{i}.{k}"] = v.clone()
    return out


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_loop_logs_the_references_steps_stages_and_alphas(dataset,
                                                          tmp_path):
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    j_train(JConfig().with_overrides(OVERRIDES), None, num_steps=STEPS,
            workdir=jdir, device_dataset=dataset)
    state = train(_config(), None, num_steps=STEPS, workdir=tdir,
                  device_dataset=dataset, device="cpu")
    assert state.step == STEPS
    want = _logged(jdir)
    assert want == [(3, 0, 1.0), (6, 1, 0.75), (8, 1, 1.0), (11, 1, 1.0),
                    (12, 1, 1.0)]
    assert _logged(tdir) == want

    def ckpts(d):
        return sorted(int(p) for p in os.listdir(os.path.join(
            d, "checkpoints")) if p.isdigit())

    assert ckpts(tdir) == ckpts(jdir) == [6, 8, 12]
    assert _ema_meta(tdir) == _ema_meta(jdir) == (12, 1)


def test_resume_is_bit_equal_to_an_unbroken_run(dataset, tmp_path):
    whole = train(_config(), None, num_steps=STEPS,
                  workdir=str(tmp_path / "whole"), device_dataset=dataset,
                  device="cpu")
    broken = str(tmp_path / "broken")
    assert train(_config(), None, num_steps=7, workdir=broken,
                 device_dataset=dataset, device="cpu").step == 7
    resumed = train(_config(), None, num_steps=STEPS - 7, workdir=broken,
                    device_dataset=dataset, device="cpu")
    _assert_bit_equal(_bits(resumed), _bits(whole))
    steps = [s for s, _, _ in _logged(broken)]
    assert steps == [3, 6, 7, 8, 11, 12]


def test_stop_file_present_at_start_is_honoured(dataset, tmp_path):
    workdir = tmp_path / "run"
    workdir.mkdir()
    (workdir / "STOP").write_text("stop\n")
    with pytest.warns(UserWarning, match="STOP file"):
        state = train(_config(), None, num_steps=STEPS, workdir=str(workdir),
                      device_dataset=dataset, device="cpu")
    assert state.step == 3
    assert not (workdir / "STOP").exists()
    assert Checkpointer(str(workdir / "checkpoints")).steps() == [3]
    assert _ema_meta(str(workdir)) == (3, 0)


def _stream(dataset, batch, offset=0):
    """Batch i holds examples (offset + i * batch + j) mod N."""
    waves, pitches = dataset
    i = 0
    while True:
        idx = (offset + i * batch + np.arange(batch)) % len(waves)
        yield waves[idx], pitches[idx]
        i += 1


@pytest.mark.parametrize("unroll", [1, 2])
def test_data_iter_resume_fast_forwards(dataset, tmp_path, unroll):
    cfg = _config(unroll=unroll, stage_stable_steps=[2, 6, 4, 4, 4, 4, 4])
    whole = train(cfg, _stream(dataset, 2), num_steps=5,
                  workdir=str(tmp_path / "whole"), device="cpu")
    broken = str(tmp_path / "broken")
    train(cfg, _stream(dataset, 2), num_steps=3, workdir=broken,
          device="cpu")
    # a fresh stream at position 0: the loop skips the 3 batches it used
    resumed = train(cfg, _stream(dataset, 2), num_steps=2, workdir=broken,
                    device="cpu")
    _assert_bit_equal(_bits(resumed), _bits(whole))
    with pytest.raises(ValueError, match="ahead"):
        train(cfg, _stream(dataset, 2), num_steps=1, workdir=broken,
              data_position=99, device="cpu")


def test_data_factory_builds_each_stage_at_its_place(dataset, tmp_path):
    cfg = _config(stage_batch_sizes=[2, 1, 1, 1, 1, 1, 1],
                  pitch_consistency_release_step=None)
    calls = []

    def factory(stage, batch, skip):
        calls.append((stage, batch, skip))
        return _stream(dataset, batch, offset=7 * stage + batch * skip)

    whole = train(cfg, None, num_steps=8, workdir=str(tmp_path / "whole"),
                  data_factory=factory, device="cpu")
    assert calls == [(0, 2, 0), (1, 1, 0)]
    calls.clear()
    broken = str(tmp_path / "broken")
    train(cfg, None, num_steps=5, workdir=broken, data_factory=factory,
          device="cpu")
    resumed = train(cfg, None, num_steps=3, workdir=broken,
                    data_factory=factory, device="cpu")
    assert calls == [(0, 2, 0), (1, 1, 0), (1, 1, 2)]
    _assert_bit_equal(_bits(resumed), _bits(whole))
    with pytest.raises(ValueError, match="stage_batch_sizes"):
        train(cfg, _stream(dataset, 2), num_steps=1, device="cpu")


@pytest.mark.parametrize("route", ["device_dataset", "data_iter"])
def test_log_lines_carry_the_step_phases(dataset, tmp_path, route):
    """Every log line keeps the step's metrics and ``steps_per_sec`` and
    adds each phase's ms a step since the last log and the host's
    staging; over the run they come to the steps' time."""
    cfg = _config(unroll=3 if route == "device_dataset" else 1)
    kwargs = ({"device_dataset": dataset} if route == "device_dataset"
              else {"data_iter": _stream(dataset, 2)})
    t0 = time.perf_counter()
    train(cfg, kwargs.pop("data_iter", None), num_steps=6,
          workdir=str(tmp_path), device="cpu", **kwargs)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    phases = [f"phase_ms/{p}" for p in ("frontend", "critic", "generator",
                                        "ema", "between")]
    prev, steps_ms = 0, 0.0
    for line in lines:
        assert {"d_loss", "g_loss", "alpha", "steps_per_sec",
                "host_stage_ms", *phases} <= set(line)
        assert all(line[k] > 0 for k in phases[:4])
        assert line["host_stage_ms"] > 0
        steps_ms += (line["step"] - prev) * sum(line[k] for k in phases)
        prev = line["step"]
    assert prev == 6
    assert 0 < steps_ms < wall_ms


def test_sample_dumps_write_the_keyed_samplers_notes(dataset, tmp_path):
    cfg = _config(sample_every=3, sample_pitches=[36, 60])
    train(cfg, None, num_steps=6, workdir=str(tmp_path),
          device_dataset=dataset, device="cpu")
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "step00000003_pitch36.wav", "step00000003_pitch60.wav",
        "step00000006_pitch36.wav", "step00000006_pitch60.wav"]


@pytest.mark.parametrize("stage", [0, 2])
def test_keyed_sampler_matches_the_reference(stage):
    jcfg = JConfig().with_overrides(OVERRIDES)
    jstate = j_create(jcfg, seed=4)
    tcfg = _config()
    g = create_train_state(tcfg, seed=0, device="cpu").ema
    g.load_state_dict(from_jax_params(jstate.ema_params))
    key = jax.random.fold_in(jax.random.key(tcfg.train.seed), 415010)
    pitches = [36, 60, 84]
    want_w, want_i = j_make_sampler(jcfg, stage)(
        jstate.ema_params, key, jnp.asarray(pitches, jnp.int32))
    got_w, got_i = make_sampler(tcfg, g, stage)(
        R.fold_in(R.seed_to_key(tcfg.train.seed), 415010), pitches)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=2e-5)
    err = np.abs(np.asarray(want_w) - got_w.numpy())
    assert err.max() < 5e-3
    snr = 10 * np.log10(np.sum(np.asarray(want_w) ** 2)
                        / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0


@pytest.fixture(scope="module")
def plain_run(dataset, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("plain"))
    state = train(_config(), None, num_steps=STEPS, workdir=workdir,
                  device_dataset=dataset, device="cpu")
    return _bits(state), _logged(workdir)


@pytest.mark.parametrize("layout,with_mesh", [
    ("replicate", True), ("shard", True), ("shard", False)])
def test_a_one_rank_mesh_and_the_cache_layouts_equal_the_plain_loop(
        dataset, plain_run, tmp_path, layout, with_mesh):
    """The reference's mesh arguments now run: a mesh of one rank (no
    collective runs) and either cache layout, with or without it, end
    bit-equal to the plain loop, as the reference's one-device mesh equals
    its plain program (``tests/test_parallel.py``)."""
    from gansynth_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh(rank=0, world=1, device=torch.device("cpu")) \
        if with_mesh else None
    got = train(_config(device_cache_layout=layout), None, num_steps=STEPS,
                workdir=str(tmp_path), device_dataset=dataset,
                mesh=mesh, device="cpu")
    _assert_bit_equal(_bits(got), plain_run[0])
    assert _logged(str(tmp_path)) == plain_run[1]


def test_use_mesh_needs_a_process_group(dataset):
    with pytest.raises(RuntimeError, match="process group"):
        train(_config(), None, num_steps=1, device_dataset=dataset,
              device="cpu", use_mesh=True)


def test_resume_refuses_an_orbax_checkpoint(dataset, tmp_path):
    """The newest step under ``checkpoints/`` is the reference's orbax
    directory (no ``state.pt``): the loop refuses to go on from an older
    state and names it."""
    os.makedirs(tmp_path / "checkpoints" / "5" / "default")
    with pytest.raises(ValueError, match="orbax"):
        train(_config(), None, num_steps=1, workdir=str(tmp_path),
              device_dataset=dataset, device="cpu")
