"""The port's data parallelism (``gansynth_tpu_torch/parallel``) against the
reference's on the CPU.

The reference's DP step runs on the conftest's 8-device CPU mesh
(``jit_train_step_for_mesh``, ``shard_train_inputs``), once a step of the
supersteps (a ``lax.scan`` superstep equals its steps taken one by one
within rtol 2e-5, ``tests/test_superstep.py``), the cached ones on the
batches of the reference's ``cached_batch_indices``. The port's
step runs in 2 and in 4 spawned gloo processes (``torch_dp_worker.py``,
which imports no JAX), once per module for every scenario. Both start
from the reference's weights; every step gets the reference's
z_d, u and z_g (the supersteps' steps each their own), and the port's
frontend is handed the reference's real images
(``torch_step_parity.py``).

Bars are the reference's own for DP against one device
(``tests/test_parallel.py:67-73``): metrics ``rtol=2e-4, atol=2e-5``,
weights and EMA ``rtol=2e-3, atol=2e-5``. The single steps' weights are
held to the reference's mesh at those bars. A run of three steps is not
held element by element: Adam's first steps move a weight whose gradient
sits at the noise floor by a full lr either way, whatever the summation
order (``torch_step_parity.check`` allows 2 lr a step for it between the
packages), and the critic's moved weights then shift the generator's
next gradient. Measured over the cached superstep's three steps between
2 ranks and one process: the per-step losses agree to 7e-6 relative, and
9 of the generator's 55,182 weights fall outside the weight bar (at most
2.3x, 9.2e-5). So the supersteps' metrics are held to the reference's
mesh at its bar, and their weights to the port's own run of the same
steps in one process: every weight within 2 lr a step, and at most 1 in
1,000 of a network's weights outside the bars.

Also: ``--mbstd per-replica`` at 2 ranks differs from the global
statistic; an indivisible batch and an indivisible sharded cache are
refused as the reference refuses them; a STOP file on rank 1 only stops
both ranks at the same step.
"""

import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker as worker
from gansynth_tpu.parallel import (
    jit_train_step_for_mesh,
    make_mesh,
    shard_train_inputs,
)
from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.train import make_train_step as j_make_step
from gansynth_tpu.train.step import cached_batch_indices as j_indices
from gansynth_tpu.train.step import real_image_for_stage as j_real
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.parallel import sharding
from gansynth_tpu_torch.train.loop import train
from gansynth_tpu_torch.utils.checkpoint import from_jax_params

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

STAGE = worker.STAGE
ALPHA = 0.7
WORLDS = (2, 4)
SCENARIOS = ("step", "per_replica", "superstep", "cached_replicate",
             "cached_shard")


def _jconfig(**model):
    return JConfig().with_overrides(
        {"model": {**worker.TINY["model"], **model},
         "train": worker.TINY["train"]})


def _dataset():
    rng = np.random.default_rng(11)
    t = np.arange(64000) / 16000
    freqs = 110.0 * 2 ** (np.arange(16) / 5)
    waves = np.stack([np.sin(2 * np.pi * f * t) for f in freqs])
    waves = (waves + 0.01 * rng.standard_normal(waves.shape))
    return waves.astype(np.float32), np.arange(36, 52, dtype=np.int32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results, and the inputs file the workers read."""
    tmp = tmp_path_factory.mktemp("dp")
    data_w, data_p = _dataset()
    waves, pitch = data_w[:8], data_p[:8]
    chunk_idx = np.stack([np.arange(8), np.arange(8, 16), np.arange(4, 12)])
    chunk_w, chunk_p = data_w[chunk_idx], data_p[chunk_idx]
    alphas = np.asarray([0.5, 0.75, 1.0], np.float32)
    jcfg = _jconfig()
    state = j_create(jcfg, seed=0)
    noise = {}
    for step in range(3):   # as the reference's step draws it
        k_zd, k_u, k_zg = jax.random.split(
            jax.random.fold_in(state.rng, step), 3)
        noise.update({f"z_d{step}": jax.random.normal(k_zd, (8, 8)),
                      f"u{step}": jax.random.uniform(k_u, (8, 1, 1, 1)),
                      f"z_g{step}": jax.random.normal(k_zg, (8, 8))})
    images = np.asarray(j_real(jnp.asarray(data_w), STAGE, jcfg))
    inputs = {"waves": waves, "pitch": pitch, "data_waves": data_w,
              "data_pitches": data_p, "data_images": images,
              "chunk_waves": chunk_w, "chunk_pitches": chunk_p,
              "alphas": alphas,
              **{k: np.asarray(v) for k, v in noise.items()}}
    for net, params in (("g", state.g_params), ("d", state.d_params)):
        for k, v in from_jax_params(params).items():
            inputs[f"{net}/{k}"] = v.numpy()
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)

    mesh = make_mesh()
    results = {}

    def steps(cfg, batches, alphas_, step_fn):
        """The reference's DP step over ``batches(state)`` from its seed-0
        state: its final state and the metrics averaged over the steps, as
        a superstep reports them, with the last alpha."""
        st, metrics = j_create(cfg, seed=0), []
        for (w, p), alpha in zip(batches(st), alphas_):
            st, w, p = shard_train_inputs(mesh, st, w, p)
            st, m = step_fn(st, w, p, jnp.float32(alpha))
            metrics.append(m)
        out = {k: np.mean([float(m[k]) for m in metrics]) for k in metrics[0]}
        out["alpha"] = float(alphas_[-1])
        return st, out

    step_fn = jit_train_step_for_mesh(j_make_step(jcfg, STAGE), mesh)
    one = [(jnp.asarray(waves), jnp.asarray(pitch))]
    results["step"] = steps(jcfg, lambda st: one, [ALPHA], step_fn)
    for world in WORLDS:
        cfg = _jconfig(mbstd_replicas=world)
        results[f"per_replica{world}"] = steps(
            cfg, lambda st: one, [ALPHA],
            jit_train_step_for_mesh(j_make_step(cfg, STAGE), mesh))
    results["superstep"] = steps(
        jcfg, lambda st: zip(jnp.asarray(chunk_w), jnp.asarray(chunk_p)),
        alphas, step_fn)

    def cached(st):   # the cached stream's batches, as its superstep reads
        idx = [np.asarray(j_indices(st.rng, k, 8, 16))
               for k in range(len(alphas))]
        return [(jnp.asarray(data_w[i]), jnp.asarray(data_p[i]))
                for i in idx]

    # both layouts give the reference's one stream
    # (tests/test_parallel.py::TestDeviceCacheOnMesh)
    results["cached_replicate"] = results["cached_shard"] = steps(
        jcfg, cached, alphas, step_fn)
    return path, results


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results, ``{world: [rank 0's, ...]}``: a group of 2 and
    a group of 4 spawned processes, run at the same time."""
    inputs, _ = reference
    outs, errors = {}, []

    def group(world):
        out = str(tmp_path_factory.mktemp(f"w{world}"))
        try:
            mp.start_processes(worker.run, nprocs=world, start_method="spawn",
                               args=(world, _free_port(), inputs, out))
        except Exception as e:   # raised again below, on the test's thread
            errors.append(e)
        outs[world] = out

    threads = [threading.Thread(target=group, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive(), "a data-parallel group did not finish"
    if errors:
        raise errors[0]
    return {w: [torch.load(os.path.join(outs[w], f"rank{r}.pt"),
                           weights_only=False) for r in range(w)]
            for w in WORLDS}


def _check_metrics(want_metrics, got):
    for k in want_metrics:
        np.testing.assert_allclose(got["metrics"][k],
                                   float(want_metrics[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=f"metric {k}")


def _check_weights(want, got, steps=0):
    """``want``: {net: {port name: tensor}}. With ``steps``, the weights
    of a run of that many steps: each within 2 lr a step, and at most 1
    in 1,000 of a network's outside the bars."""
    lr = worker.config().train.learning_rate
    for net in ("g", "d", "ema"):
        assert set(want[net]) == set(got[net])
        outside = total = 0
        for k, v in want[net].items():
            a, b = got[net][k].numpy(), v.numpy()
            if not steps:
                np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5,
                                           err_msg=f"{net} {k}")
                continue
            diff = np.abs(a - b)
            assert diff.max() <= 2 * lr * steps + 1e-6, f"{net} {k}"
            outside += int((diff > 2e-5 + 2e-3 * np.abs(b)).sum())
            total += b.size
        assert outside <= total // 1000, (net, outside, total)


def _reference_weights(state):
    return {"g": from_jax_params(state.g_params),
            "d": from_jax_params(state.d_params),
            "ema": from_jax_params(state.ema_params)}


# scenario -> the port's run of it in one process (rank 0 of the group)
ONE_PROCESS = {"superstep": "one_superstep", "cached_replicate": "one_cached",
               "cached_shard": "one_cached"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_dp_equals_the_reference_mesh(reference, ranks, scenario, world):
    _, results = reference
    key = f"per_replica{world}" if scenario == "per_replica" else scenario
    state, metrics = results[key]
    got = ranks[world][0][scenario]
    _check_metrics(metrics, got)
    assert got["step"] == int(state.step)
    if scenario in ONE_PROCESS:
        _check_weights(ranks[world][0][ONE_PROCESS[scenario]], got,
                       steps=got["step"])
    else:
        _check_weights(_reference_weights(state), got)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_ranks_hold_the_same_state(ranks, scenario, world):
    first = ranks[world][0][scenario]
    for other in ranks[world][1:]:
        assert other[scenario]["metrics"] == first["metrics"]
        for net in ("g", "d", "ema"):
            for k, v in first[net].items():
                assert torch.equal(other[scenario][net][k], v), (net, k)


def test_multislice_grouping_equals_the_reference(reference, ranks):
    """The 2x2 (replica, data) grouping at 4 ranks runs the 1-D step with
    a hierarchical gradient all-reduce: the reference's mesh step, which
    its (replica, data) mesh equals (``tests/test_parallel.py:93``)."""
    state, metrics = reference[1]["step"]
    got = ranks[4][0]["multislice"]
    _check_metrics(metrics, got)
    _check_weights(_reference_weights(state), got)


def test_per_replica_differs_from_global(ranks):
    got = ranks[2][0]
    assert got["per_replica"]["metrics"]["d_loss"] != \
        got["step"]["metrics"]["d_loss"]


def test_stop_on_one_rank_stops_every_rank(ranks):
    """STOP in rank 1's run directory only: both ranks stop at the first
    log crossing (step 2 of 6), rank 1's file is consumed, and only rank 0
    wrote a checkpoint."""
    r0, r1 = (r["stop"] for r in ranks[2])
    assert r0["step"] == r1["step"] == 2
    assert not r1["stop_left"]
    assert r0["checkpoints"] == ["2"] and r1["checkpoints"] == []


def test_indivisible_batch_is_refused():
    mesh = sharding.Mesh(rank=0, world=4, device=torch.device("cpu"),
                         grouped=True)   # refused before a collective
    waves, pitch = _dataset()
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_train_inputs(mesh, waves[:6], pitch[:6])


def test_indivisible_sharded_cache_is_refused():
    """N = 15 over 2 ranks: refused before the loop's first collective."""
    mesh = sharding.Mesh(rank=0, world=2, device=torch.device("cpu"),
                         grouped=True)   # refused before a collective
    cfg = worker.config().with_overrides(
        {"train": {"device_cache_layout": "shard"}})
    waves, pitch = _dataset()
    with pytest.raises(ValueError, match="divisible"):
        train(cfg, None, num_steps=1, mesh=mesh,
              device_dataset=(waves[:15], pitch[:15]))


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh()


def test_prefetch_takes_the_ranks_rows_depth_ahead():
    """``data/prefetch.py``: a global batch is cut to the rank's rows, a
    local one (``--multihost``) taken as is; two batches are read ahead of
    the one the step consumes."""
    from gansynth_tpu_torch.data.prefetch import prefetch_to_mesh

    mesh = sharding.Mesh(rank=1, world=2, device=torch.device("cpu"),
                         grouped=True)   # no collective in the infeed
    read = []

    def stream():
        for i in range(4):
            read.append(i)
            n = 4 if i % 2 == 0 else 2   # global, local, global, local
            yield (np.full((n, 3), i, np.float32),
                   np.arange(n, dtype=np.int32) + 10 * i)

    it = prefetch_to_mesh(stream(), mesh, 4)
    wave, pitch = next(it)
    assert read == [0, 1, 2]
    assert wave.dtype == torch.float32 and pitch.dtype == torch.int32
    assert pitch.tolist() == [2, 3] and wave.shape == (2, 3)
    assert next(it)[1].tolist() == [10, 11]
    assert [p.tolist() for _, p in it] == [[22, 23], [30, 31]]
