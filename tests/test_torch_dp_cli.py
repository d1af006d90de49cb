"""``cli train --data-parallel``, ``--multihost``, ``--mbstd per-replica``
and ``--device-cache-layout shard`` on the CPU, as a launcher
(``torchrun``) runs them: two processes of ``python -m
gansynth_tpu_torch.cli train ... --device cpu`` each, with ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set,
in one gloo group. All runs start at once (TensorFlow hidden, as on the
card's machine).

Each data-parallel run is held to the same command in one process on the
same global batches (the step's parity with the reference is
``test_torch_parallel.py``'s and the single process's is
``test_torch_train_step.py``'s): the logged losses of both steps at the
reference's DP bar (``rtol=2e-4, atol=2e-5``), and the weights and EMA
of the last checkpoint within 2 lr a step, at most 1 in 1,000 of a
network's outside ``rtol=2e-3, atol=2e-5`` (``test_torch_parallel.py``
says why). ``--mbstd per-replica`` at 2 ranks is held to one process
with ``mbstd_replicas=2`` and differs from the global run; its
``--dump-config`` under a launcher of 8 is the reference's on the
conftest's 8 devices. ``--multihost`` decodes each rank's slice of the
stream and trains. Only rank 0 writes the run's files.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gansynth_tpu.cli import main as j_main
from gansynth_tpu_torch import cli
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": {"latent_dim": 8, "fmap_base": 64, "fmap_max": 16,
                  "fmap_min": 8},
        "train": {"batch_size": 4, "stage_fade_steps": [0, 3, 3, 3, 3, 3, 3],
                  "stage_stable_steps": [3, 100, 3, 3, 3, 3, 3],
                  "unroll": 1, "checkpoint_every": 2, "log_every": 1}}
STEPS = 2
RUNS = {   # name -> the flags of a 2-rank run
    "replicate": ["--data-parallel", "--device-cache"],
    "shard": ["--data-parallel", "--device-cache",
              "--device-cache-layout", "shard"],
    "per_replica": ["--data-parallel", "--device-cache", "--mbstd",
                    "per-replica"],
    "multihost": ["--multihost"],
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: run directory}`` of the 2-rank runs and of the one-process
    runs ``one`` and ``one_r2`` (``mbstd_replicas=2``)."""
    tmp = tmp_path_factory.mktemp("dpcli")
    tiny = _write(tmp / "tiny.json", TINY)
    tiny_r2 = _write(tmp / "tiny_r2.json", {
        **TINY, "model": {**TINY["model"], "mbstd_replicas": 2}})
    notes = str(tmp / "notes.tfrecord")
    assert cli.main(["fixtures", "--output", notes, "--num-examples", "16",
                     "--seed", "2"]) == 0
    stub = tmp / "no_tensorflow" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        'raise ImportError("TensorFlow is hidden in this test")\n')

    def argv(run, config, flags):
        return ["train", "--model-dir", str(tmp / run), "--data", notes,
                "--device", "cpu", "--config", config, "--num-steps",
                str(STEPS), *flags]

    procs = []
    for name, flags in RUNS.items():
        port = _free_port()
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = os.pathsep.join(
                [ROOT, str(stub.parent), env.get("PYTHONPATH", "")])
            procs.append((name, subprocess.Popen(
                [sys.executable, "-m", "gansynth_tpu_torch.cli",
                 *argv(name, tiny, flags)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, config in (("one", tiny), ("one_r2", tiny_r2)):
        assert cli.main(argv(name, config, ["--device-cache"])) == 0
    for name, proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            pytest.fail(f"{name}: a rank did not finish")
        assert proc.returncode == 0, f"{name}:\n{out[-4000:]}"
    return {name: str(tmp / name) for name in [*RUNS, "one", "one_r2"]}


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _weights(run):
    path = os.path.join(run, "checkpoints", str(STEPS), "state.pt")
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("name,one", [("replicate", "one"), ("shard", "one"),
                                      ("per_replica", "one_r2")])
def test_data_parallel_run_equals_one_process(runs, name, one):
    got, want = _metrics(runs[name]), _metrics(runs[one])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        for k in w:
            if k not in ("steps_per_sec", "step", "stage"):
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4,
                                           atol=2e-5, err_msg=k)
    got, want = _weights(runs[name]), _weights(runs[one])
    lr = 8e-4
    for net in ("g", "d", "ema"):
        outside = total = 0
        for k, v in want[net].items():
            diff = (got[net][k] - v).abs()
            assert float(diff.max()) <= 2 * lr * STEPS + 1e-6, (net, k)
            outside += int((diff > 2e-5 + 2e-3 * v.abs()).sum())
            total += v.numel()
        assert outside <= total // 1000, (net, outside, total)


def test_per_replica_differs_from_global(runs):
    assert _metrics(runs["per_replica"])[0]["d_loss"] != \
        _metrics(runs["replicate"])[0]["d_loss"]
    with open(os.path.join(runs["per_replica"], "train_config.json")) as f:
        assert json.load(f)["model"]["mbstd_replicas"] == 2


@pytest.mark.parametrize("name", list(RUNS))
def test_only_rank_0_writes_the_run(runs, name):
    """One ``metrics.jsonl`` line a step (not one a rank), the checkpoint
    and ``ema.npz`` at the last step."""
    records = _metrics(runs[name])
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["d_loss"]) for r in records)
    assert sorted(os.listdir(os.path.join(runs[name], "checkpoints"))) == \
        ["2"]
    with np.load(os.path.join(runs[name], "ema.npz")) as z:
        assert int(z["__step__"]) == STEPS


def test_multihost_reads_its_slice(runs):
    """Each rank decodes half of every global batch (``num_shards`` = 2):
    the run's batches are not the one-process stream's."""
    assert _metrics(runs["multihost"])[0]["d_loss"] != \
        _metrics(runs["one"])[0]["d_loss"]


def test_per_replica_dump_config_matches_the_reference(tmp_path, capsys,
                                                       monkeypatch):
    """Under a launcher of 8 the port's ``mbstd_replicas`` is 8, as the
    reference's is ``len(jax.devices())``, 8 under the conftest."""
    argv = ["train", "--model-dir", str(tmp_path), "--dump-config",
            "--mbstd", "per-replica"]
    dumps = []
    for main in (j_main, cli.main):
        if main is cli.main:
            monkeypatch.setenv("WORLD_SIZE", "8")
        with pytest.raises(SystemExit):
            main(argv)
        dumps.append(json.loads(capsys.readouterr().out))
    assert dumps[0]["model"]["mbstd_replicas"] == 8
    assert dumps[1] == dumps[0]
