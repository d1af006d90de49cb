"""The port's ``train``, ``stop``, ``supervise``, ``export-ema`` and
``fixtures`` commands on the CPU (``--device cpu``).

- ``train --dump-config`` prints the reference's JSON for the same flags.
- What the port refuses (``--ingest tf``, ``--data-parallel``,
  ``--multihost``, ``--mbstd per-replica``, ``--device-cache-layout
  shard``) exits 2 with an error; without ``--device cpu`` and without a
  card, ``train`` raises instead of running on the CPU.
- ``train --synthetic --device-cache`` writes ``checkpoints/<step>/``,
  ``ema.npz`` and ``metrics.jsonl``; a second call resumes where the
  first stopped; ``export-ema`` archives the latest checkpoint; ``serve``
  loads the ``ema.npz`` that training wrote.
- ``supervise`` restarts a child wedged mid-run (the injected stall of
  ``GANSYNTH_TRAIN_STALL``) from its latest checkpoint, and on SIGTERM
  stops the child through the STOP file with exit 0. The children run
  with TensorFlow hidden, as on the card's machine (so
  ``torch.utils.tensorboard`` does not spend seconds importing it).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gansynth_tpu.cli import main as j_main
from gansynth_tpu_torch import cli
from gansynth_tpu_torch import serve as tserve
from gansynth_tpu_torch.train.supervisor import Supervisor
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": {"latent_dim": 8, "fmap_base": 64, "fmap_max": 16,
                  "fmap_min": 8},
        "train": {"batch_size": 2, "stage_fade_steps": [0, 3, 3, 3, 3, 3, 3],
                  "stage_stable_steps": [3, 100, 3, 3, 3, 3, 3],
                  "unroll": 2, "checkpoint_every": 2, "log_every": 1}}


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


@pytest.fixture(scope="module")
def notes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "notes.tfrecord")
    assert cli.main(["fixtures", "--output", path, "--num-examples", "16",
                     "--seed", "2"]) == 0
    return path


def _dump(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    assert exit_info.value.code == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("flags", [
    [],
    ["--batch-size", "4", "--unroll", "50", "--stage-batch-sizes",
     "64,64,32,32,16,8,8", "--compute-dtype", "bfloat16", "--seed", "1",
     "--pitch-consistency", "10", "--pitch-consistency-release", "208000",
     "--stage-fade-steps", "0,8000,8000,8000,10000,10000,12000",
     "--checkpoint-every", "5000", "--log-every", "500",
     "--sample-every", "40000", "--fused-critic", "pair"],
    ["--config", "TINY", "--fmap-max", "32", "--latent-dim", "16"],
])
def test_dump_config_matches_the_reference(flags, tiny_config, capsys,
                                           tmp_path):
    flags = [tiny_config if f == "TINY" else f for f in flags]
    argv = ["train", "--model-dir", str(tmp_path), "--dump-config", *flags]
    want = _dump(j_main, argv, capsys)
    got = _dump(cli.main, argv, capsys)
    assert got == want


@pytest.mark.parametrize("flags,word", [
    (["--ingest", "tf"], "TensorFlow"),
    (["--data-parallel"], "queue 1 item 4"),
    (["--multihost"], "queue 1 item 4"),
    (["--mbstd", "per-replica"], "queue 1 item 4"),
    (["--device-cache-layout", "shard"], "queue 1 item 4"),
])
def test_refused_flags_exit_2(flags, word, tmp_path, capsys):
    argv = ["train", "--model-dir", str(tmp_path), "--synthetic",
            "--device", "cpu", *flags]
    assert cli.main(argv) == 2
    assert word in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_train_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--model-dir", str(tmp_path), "--synthetic"])


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_resumes_exports_and_serves(tiny_config, tmp_path,
                                          monkeypatch, capsys):
    run = str(tmp_path / "run")
    argv = ["train", "--model-dir", run, "--synthetic", "--device-cache",
            "--device", "cpu", "--config", tiny_config]
    assert cli.main([*argv, "--num-steps", "3"]) == 0
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2", "3"]
    with np.load(os.path.join(run, "ema.npz")) as z:
        assert (int(z["__step__"]), int(z["__stage__"])) == (3, 0)
    assert cli.main([*argv, "--num-steps", "2"]) == 0
    assert [r["step"] for r in _metrics(run)] == [2, 3, 5]
    assert [r["stage"] for r in _metrics(run)] == [0, 0, 1]
    with np.load(os.path.join(run, "ema.npz")) as z:
        assert (int(z["__step__"]), int(z["__stage__"])) == (5, 1)
    with open(os.path.join(run, "train_config.json")) as f:
        assert json.load(f)["train"]["unroll"] == 2

    out = str(tmp_path / "ema16.npz")
    assert cli.main(["export-ema", "--model-dir", run, "--device", "cpu",
                     "--output", out, "--dtype", "float16"]) == 0
    with np.load(out) as z, np.load(os.path.join(run, "ema.npz")) as w:
        assert int(z["__step__"]) == 5
        k = "['params']['to_rgb_1']['kernel']"
        assert z[k].dtype == np.float16
        np.testing.assert_array_equal(z[k], w[k].astype(np.float16))

    served = []

    def fake_serve_forever(service, host, port):
        served.append(service)
        service.close()

    monkeypatch.setattr(tserve, "serve_forever", fake_serve_forever)
    capsys.readouterr()
    assert cli.main(["serve", "--model-dir", run, "--device", "cpu",
                     "--max-batch", "1"]) == 0
    assert len(served) == 1
    assert "from step 5 (sampling at stage 1" in capsys.readouterr().out


def test_stop_writes_the_request(tmp_path, capsys):
    assert cli.main(["stop", "--model-dir", str(tmp_path / "none")]) == 2
    assert cli.main(["stop", "--model-dir", str(tmp_path)]) == 0
    assert (tmp_path / "STOP").exists()
    assert cli.main(["stop", "--model-dir", str(tmp_path),
                     "--wait", "0.5"]) == 1   # nothing consumes it


@pytest.fixture
def child_env(tmp_path):
    """The repo on the path, TensorFlow hidden, two PyTorch threads (as
    ``torch_threads.py`` gives this file's own tests)."""
    stub = tmp_path / "no_tensorflow" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        'raise ImportError("TensorFlow is hidden in this test")\n')
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, str(stub.parent), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    return env


def _train_argv(model_dir, notes, tiny_config, steps):
    return ["--model-dir", model_dir, "--data", notes, "--device-cache",
            "--device", "cpu", "--config", tiny_config,
            "--num-steps", str(steps)]


def test_supervisor_restarts_a_stalled_child(tmp_path, notes, tiny_config,
                                             child_env):
    model_dir, flag = str(tmp_path / "run"), str(tmp_path / "stall.flag")
    child_env["GANSYNTH_TRAIN_STALL"] = f"4:{flag}"
    msgs = []
    sup = Supervisor(_train_argv(model_dir, notes, tiny_config, 6),
                     model_dir, min_stall_s=20.0, startup_grace_s=300.0,
                     max_restarts=2, poll_s=0.2, log=msgs.append,
                     child_env=child_env)
    assert sup.run() == 0, msgs
    assert (sup.stalls_detected, sup.restarts) == (1, 1), msgs
    assert os.path.exists(flag)
    # child 1: steps 2, 3 (the stage change), 5, checkpoint 5, wedge;
    # child 2 resumes at 5 and takes its 6 steps
    steps = [r["step"] for r in _metrics(model_dir)]
    assert steps == [2, 3, 5, 7, 9, 11], steps


def test_supervise_sigterm_stops_the_child_cleanly(tmp_path, notes,
                                                   tiny_config, child_env):
    model_dir = str(tmp_path / "run")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gansynth_tpu_torch.cli", "supervise",
         "--stall-timeout", "120", "--stop-grace", "120", "--",
         *_train_argv(model_dir, notes, tiny_config, 100000)],
        env=child_env, cwd=ROOT)
    try:
        metrics = os.path.join(model_dir, "metrics.jsonl")
        deadline = time.time() + 240
        while not (os.path.exists(metrics) and os.path.getsize(metrics)):
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not os.path.exists(os.path.join(model_dir, "STOP"))
    last = _metrics(model_dir)[-1]["step"]
    assert last < 100000
    assert int(max(os.listdir(os.path.join(model_dir, "checkpoints")),
                   key=int)) == last
