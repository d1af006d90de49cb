"""The port's offline commands (``generate``, ``interpolate``,
``evaluate``, ``roundtrip``) and its restore, against the reference's CLI
on one tiny run directory (``tests/torch_tiny_run.py``), on the CPU.

- ``generate`` and ``interpolate`` write the reference's file names, with
  waves within the repo's synthesis bar (max abs error < 5e-3, SNR >
  40 dB: the two frameworks' f32 generators and spectral paths differ in
  rounding, measured here at <= 14 of 32767 per 16-bit sample).
- ``evaluate`` writes the reference's keys plus ``reference_set`` and
  ``reference_files``, with every number within ``EVAL_RTOL`` (below).
- ``roundtrip`` prints the reference's SNR within 0.01 dB.
- ``_restore_sampler`` picks the reference's weights, stage and config:
  a full checkpoint over a float16 ``ema.npz`` of the same step; the
  schedule's stage where ``ema.npz`` records none (and renders there,
  below the final stage, as the reference does); ``--latent-dim`` and
  ``--config`` over ``train_config.json``. ``serve`` restores through it.
- ``interpolate --from-exported`` renders from an ``export-model
  --with-latent`` artifact what ``--model-dir`` renders, and exits 2 on a
  seeded-only artifact; ``serve --from-exported`` answers over HTTP with
  no run directory. Without ``--device cpu`` and without a card, the
  commands raise.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import torch_tiny_run as tiny
from gansynth_tpu.cli import _restore_sampler as j_restore
from gansynth_tpu.cli import main as j_main
from gansynth_tpu.train.state import create_train_state as j_state
from gansynth_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from gansynth_tpu_torch import cli
from gansynth_tpu_torch import serve as tserve
from gansynth_tpu_torch.synth.export import (
    load_sampler_artifact,
    save_sampler_artifact,
)
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.utils.audio_io import read_wav
from gansynth_tpu_torch.utils.checkpoint import Checkpointer, to_jax_params
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

# Relative bar on evaluate's numbers. Measured between the packages on
# this run: <= 8.5e-5 for the raw (unfloored) log-spectral distance and
# Frechet distance, whose near-silent bins amplify the waves' rounding
# differences through a log; <= 3.1e-5 for the raw diversity; <= 2e-7
# for the -60 dB floored metrics; 1e-9 for the pitch errors.
EVAL_RTOL = 1e-3
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def params():
    return tiny.tiny_params()


@pytest.fixture(scope="module")
def run(params, tmp_path_factory):
    return tiny.make_run(str(tmp_path_factory.mktemp("run")), params)


def _wave_bar(want, got):
    err = np.abs(want - got)
    assert err.max() < 5e-3, err.max()
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0, snr


def _same_wavs(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        (want, sr_a), (got, sr_b) = (read_wav(os.path.join(d, name))
                                     for d in (dir_a, dir_b))
        assert sr_a == sr_b == 16000 and want.shape == got.shape
        _wave_bar(want, got)
    return names


def test_generate_matches_the_reference(run, tmp_path):
    argv = ["generate", "--model-dir", run, "--pitches", "36", "60",
            "--num-samples", "2", "--seed", "3"]
    assert j_main([*argv, "--output-dir", str(tmp_path / "j")]) == 0
    assert cli.main([*argv, "--output-dir", str(tmp_path / "t"), *CPU]) == 0
    names = _same_wavs(tmp_path / "j", tmp_path / "t")
    assert names == ["sample_0_pitch36.wav", "sample_0_pitch60.wav",
                     "sample_1_pitch36.wav", "sample_1_pitch60.wav"]


@pytest.mark.parametrize("flags", [
    ["--pitch", "60", "--pitch-b", "67", "--steps", "3"],
    ["--pitch", "48", "--steps", "4", "--mode", "lerp", "--seed-a", "5",
     "--seed-b", "9", "--crossfade-ms", "0"],
])
def test_interpolate_matches_the_reference(run, tmp_path, flags):
    argv = ["interpolate", "--model-dir", run, *flags]
    assert j_main([*argv, "--output-dir", str(tmp_path / "j")]) == 0
    assert cli.main([*argv, "--output-dir", str(tmp_path / "t"), *CPU]) == 0
    names = _same_wavs(tmp_path / "j", tmp_path / "t")
    steps = int(flags[flags.index("--steps") + 1])
    assert len(names) == steps + 1 and "morph.wav" in names


def _numbers(tree, prefix=""):
    """Every number of a JSON tree by its path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_numbers(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_numbers(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_evaluate_matches_the_reference(run, tmp_path, capsys):
    argv = ["evaluate", "--model-dir", run, "--pitches", "36", "60", "84",
            "--samples-per-pitch", "2", "--seed", "0", "--attribution"]
    assert j_main([*argv, "--output", str(tmp_path / "j.json")]) == 0
    assert cli.main([*argv, "--output", str(tmp_path / "t.json"),
                     *CPU]) == 0
    out = capsys.readouterr().out
    assert re.search(r"evaluate: rendered 6 notes in [0-9.]+ s, scored "
                     r"them in [0-9.]+ s", out)
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got.pop("reference_set") == "fixture"
    assert got.pop("reference_files") == []
    assert sorted(got) == sorted(want)
    w, g = _numbers(want), _numbers(got)
    assert sorted(w) == sorted(g)
    for path, value in w.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            np.testing.assert_allclose(g[path], value, rtol=EVAL_RTOL,
                                       err_msg=path)
        else:
            assert g[path] == value, path


def _snr(out):
    return float(re.search(r"roundtrip SNR: (-?[0-9.]+) dB", out).group(1))


@pytest.mark.parametrize("pitch", [36, 60])
def test_roundtrip_prints_the_reference_snr(pitch, capsys, tmp_path):
    argv = ["roundtrip", "--pitch", str(pitch)]
    assert j_main(argv) == 0
    want = _snr(capsys.readouterr().out)
    out = str(tmp_path / "recon.wav")
    assert cli.main([*argv, "--output", out, *CPU]) == 0
    printed = capsys.readouterr().out
    assert "mel-IF image: (1, 128, 1024, 2)" in printed
    assert abs(_snr(printed) - want) <= 0.01
    assert read_wav(out)[0].shape == (64000,)


@pytest.fixture(scope="module")
def exported(run, tmp_path_factory):
    """``(seeded-only, seeded + latent)`` artifacts of the run."""
    out = tmp_path_factory.mktemp("gsx")
    paths = (str(out / "seeded.gsx"), str(out / "both.gsx"))
    for path, flags in zip(paths, ([], ["--with-latent"])):
        assert cli.main(["export-model", "--model-dir", run, "--output",
                         path, *flags, *CPU]) == 0
    return paths


def test_interpolate_from_exported_renders_what_the_run_renders(
        run, exported, tmp_path):
    flags = ["--pitch", "60", "--pitch-b", "67", "--steps", "3", *CPU]
    assert cli.main(["interpolate", "--model-dir", run, "--output-dir",
                     str(tmp_path / "run"), *flags]) == 0
    assert cli.main(["interpolate", "--from-exported", exported[1],
                     "--output-dir", str(tmp_path / "gsx"), *flags]) == 0
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == sorted(os.listdir(tmp_path / "gsx")) and len(names) == 4
    for name in names:
        want, got = (read_wav(str(tmp_path / d / name))[0]
                     for d in ("run", "gsx"))
        rel = np.linalg.norm(want - got) / (np.linalg.norm(want) + 1e-30)
        assert rel <= 1e-3, (name, rel)   # export-model --check's bound


def test_interpolate_from_a_seeded_only_artifact_exits_2(exported, tmp_path,
                                                        capsys):
    assert cli.main(["interpolate", "--from-exported", exported[0],
                     "--output-dir", str(tmp_path), *CPU]) == 2
    assert "--with-latent" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
    junk = tmp_path / "junk.gsx"
    junk.write_bytes(b"garbage")
    assert cli.main(["interpolate", "--from-exported", str(junk),
                     "--output-dir", str(tmp_path / "out"), *CPU]) == 2
    assert cli.main(["interpolate", "--output-dir", str(tmp_path),
                     *CPU]) == 2


def test_serve_from_exported_answers_over_http(exported, params, tmp_path):
    """``serve --from-exported`` as a process of its own: no run directory,
    one request answered, ``exported_artifact`` in ``/healthz``; a pinned
    batch is refused."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="2")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "gansynth_tpu_torch.cli", "serve",
            "--from-exported", exported[0], "--port", str(port),
            "--max-batch", "1", *CPU]
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=10) as resp:
                    health = json.loads(resp.read())
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(proc.communicate(timeout=30)[0])
                time.sleep(0.5)
        assert health["exported_artifact"] is True
        assert health["device"] == "cpu"
        body = json.dumps({"pitches": [60], "seed": 3}).encode()
        req = urllib.request.Request(url + "/synthesize", data=body)
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            wav = resp.read()
        assert wav[:4] == b"RIFF" and len(wav) == 44 + 2 * 64000
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    pinned = str(tmp_path / "pinned.gsx")
    src = load_sampler_artifact(exported[0], "cpu")
    save_sampler_artifact(pinned, src.config(), tiny.port_generator(params),
                          step=1, stage=src.stage, batch=2)
    loaded = load_sampler_artifact(pinned, "cpu")
    with pytest.raises(ValueError, match="symbolic"):
        tserve.SynthesisService(loaded.config(), None, exported=loaded)
    assert cli.main(["serve", "--from-exported", pinned, *CPU]) == 2


@pytest.mark.parametrize("command", ["generate", "evaluate", "roundtrip"])
def test_commands_need_a_card_unless_asked_for_the_cpu(command, run,
                                                       tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"generate": ["--model-dir", run, "--output-dir", str(tmp_path)],
            "evaluate": ["--model-dir", run], "roundtrip": []}[command]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command, *argv])


# ----- the restore: the reference's choices in the same run directory --

def _restore_args(run, *flags):
    """The namespace ``generate`` parses, for both packages' restore."""
    ns = cli.build_parser().parse_args(
        ["generate", "--model-dir", run, "--output-dir", "unused", *CPU,
         *flags])
    return ns


def _j_restore(args):
    from gansynth_tpu.cli import _build_config

    return j_restore(args, _build_config(args))


def _t_restore(args):
    return cli._restore_sampler(args, cli._build_config(args))


def _port_weights(sampler):
    return to_jax_params(dict(sampler.generator.named_parameters()))


def _j_weights(sampler):
    flat, _ = jax.tree_util.tree_flatten_with_path(sampler.params)
    return {"".join(f"['{k.key}']" for k in path): np.asarray(leaf)
            for path, leaf in flat}


def test_restore_prefers_the_checkpoint_over_a_float16_export(params,
                                                              tmp_path):
    """Both packages' checkpoints of one EMA at step 5 sit in
    ``checkpoints/5/`` beside a float16 ``ema.npz`` of the same step: each
    package restores its checkpoint's float32 weights and the schedule's
    stage, not the export's rounded weights or recorded stage."""
    run = tiny.make_run(str(tmp_path / "run"), params, dtype="float16")
    jcfg, tcfg = tiny.configs()
    # the reference's checkpoint (orbax), EMA = params
    jstate = j_state(jcfg, seed=0).replace(ema_params=params)
    jck = JCheckpointer(os.path.join(run, "checkpoints"))
    jck.save(tiny.STEP, jstate, wait=True)
    jck.close()
    # the port's checkpoint of the same EMA, in the same step directory
    state = create_train_state(tcfg, seed=0, device="cpu",
                               ema=tiny.port_generator(params))
    state.step = tiny.STEP
    Checkpointer(str(tmp_path / "port")).save(tiny.STEP, state)
    os.replace(tmp_path / "port" / "5" / "state.pt",
               os.path.join(run, "checkpoints", "5", "state.pt"))

    args = _restore_args(run)
    j_sampler, j_step, j_stage, _ = _j_restore(args)
    t_sampler, t_step, t_stage, _ = _t_restore(args)
    assert (t_step, t_stage) == (j_step, j_stage) == (tiny.STEP, 1)
    want, got = _j_weights(j_sampler), _port_weights(t_sampler)
    assert sorted(want) == sorted(got)
    with np.load(os.path.join(run, "ema.npz")) as npz:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert npz[k].dtype == np.float16
        rounded = [k for k in want
                   if not np.array_equal(npz[k].astype(np.float32), want[k])]
    assert rounded   # the export's weights differ: the choice shows


def test_generate_on_a_run_the_reference_checkpointed(params, tmp_path,
                                                     capsys):
    """A run directory as the reference's loop leaves it: an orbax
    checkpoint at step 5 written by the reference's own ``Checkpointer``
    (no port ``state.pt`` beside it) and the ``ema.npz`` its loop writes
    with it (float32, the schedule's stage). The port falls back to
    ``ema.npz`` and generates the reference's waves; ``export-ema`` and a
    resumed ``train`` exit 2 naming the orbax checkpoint."""
    from gansynth_tpu.utils.checkpoint import save_ema_npz as j_save_npz

    run = tiny.make_run(str(tmp_path / "run"), params, stage=1)
    jcfg, _ = tiny.configs()
    jck = JCheckpointer(os.path.join(run, "checkpoints"))
    jck.save(tiny.STEP, j_state(jcfg, seed=0).replace(ema_params=params),
             wait=True)
    jck.close()
    j_save_npz(os.path.join(run, "ema.npz"), params, tiny.STEP, stage=1)
    assert not os.path.exists(os.path.join(run, "checkpoints", "5",
                                           "state.pt"))
    argv = ["generate", "--model-dir", run, "--pitches", "48", "72",
            "--seed", "4"]
    assert j_main([*argv, "--output-dir", str(tmp_path / "j")]) == 0
    assert cli.main([*argv, "--output-dir", str(tmp_path / "t"), *CPU]) == 0
    _same_wavs(tmp_path / "j", tmp_path / "t")
    capsys.readouterr()
    for command in (["export-ema", "--model-dir", run],
                    ["train", "--model-dir", run, "--synthetic",
                     "--num-steps", "1"]):
        assert cli.main([*command, *CPU]) == 2
        assert "orbax" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(run, "fixtures.tfrecord"))


def test_restore_takes_the_schedule_stage_and_renders_there(params,
                                                            tmp_path):
    """An ``ema.npz`` with no ``__stage__``: both take the schedule's
    stage at ``step - 1`` (stage 1 of 7), and the port's keyed sampler
    renders there (nearest upsample to 128x1024, then synthesis) what the
    reference's renders."""
    from gansynth_tpu_torch.synth.random import seed_to_key

    run = tiny.make_run(str(tmp_path / "run"), params, stage=None)
    with np.load(os.path.join(run, "ema.npz")) as npz:
        assert "__stage__" not in npz.files
    args = _restore_args(run)
    j_sampler, j_step, j_stage, _ = _j_restore(args)
    t_sampler, t_step, t_stage, _ = _t_restore(args)
    assert (t_step, t_stage) == (j_step, j_stage) == (tiny.STEP, 1)
    assert t_sampler.stage == 1
    want, want_img = j_sampler(jax.random.key(4), [36, 72])
    got, got_img = t_sampler(seed_to_key(4), [36, 72])
    assert tuple(got_img.shape) == (2, 4, 32, 2)   # stage 1's resolution
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=1e-5)
    _wave_bar(np.asarray(want), got.numpy())


@pytest.mark.parametrize("via", ["flag", "config"])
def test_restore_lays_model_flags_and_config_over_the_run(params, tmp_path,
                                                          via):
    """``train_config.json`` says latent 4; the weights have latent 8.
    ``--latent-dim 8`` or ``--config`` with ``model.latent_dim = 8`` takes
    effect in both packages, and their configs agree."""
    wrong = {**tiny.TINY, "model": {**tiny.TINY["model"], "latent_dim": 4}}
    run = tiny.make_run(str(tmp_path / "run"), params, config=wrong)
    if via == "flag":
        flags = ["--latent-dim", "8"]
    else:
        over = tmp_path / "over.json"
        over.write_text(json.dumps({"model": {"latent_dim": 8},
                                    "train": {"seed": 3}}))
        flags = ["--config", str(over)]
    args = _restore_args(run, *flags)
    _, _, _, j_config = _j_restore(args)
    t_sampler, _, _, t_config = _t_restore(args)
    assert t_config.model.latent_dim == j_config.model.latent_dim == 8
    assert _as_json(t_config) == _as_json(j_config)
    # latent 8 + 61 pitches into the first dense layer
    assert t_sampler.generator.latent_dense.weight.shape[-1] == 8 + 61


def _as_json(config):
    return json.loads(json.dumps(dataclasses.asdict(config)))


def test_serve_restores_through_the_same_function(run, monkeypatch, capsys):
    served = []

    def fake_serve_forever(service, host, port):
        served.append(service)
        service.close()

    monkeypatch.setattr(tserve, "serve_forever", fake_serve_forever)
    assert cli.main(["serve", "--model-dir", run, "--max-batch", "1",
                     "--latent-dim", "8", "--stage", "1", *CPU]) == 0
    assert len(served) == 1
    assert "from step 5 (sampling at stage 1" in capsys.readouterr().out


def test_restore_without_weights_raises(tmp_path):
    args = _restore_args(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ema.npz"):
        _t_restore(args)
    assert not os.path.exists(tmp_path / "checkpoints")
