"""The port's flagship generator in bf16 on the CPU against the committed
reference output (``tests/torch_reference_data.py`` states the bar and
how it was set; ``tests/test_torch_gpu.py`` holds the card to it).

Stage 6 of ``runs/flagship_r4`` (bf16), both conv routings: ``"xla"`` (the
run's own) and ``"pallas"`` (K2's plain version on the CPU). The file's
latents are the port's seeded threefry latents, which equal the
reference's ``jax.random.normal(key(seed))`` draws.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_reference_data as ref
from gansynth_tpu_torch.cli import run_config
from gansynth_tpu_torch.synth.random import seeded_latents
from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs", "flagship_r4")


def test_reference_file_provenance():
    d = ref.load()
    assert os.path.getsize(ref.PATH) < 1_100_000
    np.testing.assert_array_equal(d["z"], seeded_latents(d["seeds"], 256))
    np.testing.assert_array_equal(d["labels"].argmax(1) + 24, d["pitches"])
    assert int(d["stage"]) == 6 and d["image"].shape == (2, 128, 1024, 2)


@pytest.mark.parametrize("conv_kernel", ["xla", "pallas"])
def test_port_bf16_generator_on_cpu_within_the_bar(conv_kernel):
    d = ref.load()
    config = run_config(FLAGSHIP)
    model = dataclasses.replace(config.model, conv_kernel=conv_kernel)
    assert model.compute_dtype == "bfloat16"
    g, _, _ = load_ema_generator(os.path.join(FLAGSHIP, "ema.npz"), model,
                                 "cpu")
    with torch.no_grad():
        got = g(torch.from_numpy(d["z"]), torch.from_numpy(d["labels"]),
                int(d["stage"]), 1.0).numpy()
    gap = ref.check(got, d["image"])
    # the gap is bf16 rounding, not a fault: well inside the bar here
    assert gap["mean_abs"] < ref.MEAN_ABS_BAR / 2


def test_eval_reference_file_provenance():
    """``tests/data/flagship_eval_ref.json`` holds what
    ``tests/make_torch_reference_data.py --eval`` says it writes, at the
    settings ``chip_smoke.py``'s offline phase checks, and the port's own
    CPU run in it sits within a fifth of each of that phase's bars (where
    they were set from)."""
    import json
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke
    import make_torch_reference_data as make

    with open(make.EVAL_OUT) as f:
        d = json.load(f)
    s = d["settings"]
    assert os.path.getsize(make.EVAL_OUT) < 100_000
    assert (s["pitches"], s["seed"], s["render_chunk"]) == (
        make.EVAL_PITCHES, make.EVAL_SEED, make.RENDER_CHUNK)
    assert (s["samples_per_pitch"], s["samples_per_pitch_n8"]) == \
        make.EVAL_SAMPLES
    assert s["samples_per_pitch"] == chip_smoke.EVAL_SAMPLES
    assert (s["model_dir"], s["step"], s["stage"], s["compute_dtype"]) == (
        "runs/flagship_r4", 415000, 6, "bfloat16")
    assert (s["reference_set"], s["attribution"]) == ("fixture", True)
    assert d["metrics"]["num_samples"] == 61 * 2
    assert d["metrics_n8"]["num_samples"] == 61 * 8
    assert d["port_cpu_metrics"]["num_samples"] == 61 * 2
    assert "attribution" in d["metrics"] and "attribution" in d["metrics_n8"]
    ref, port = d["metrics"], d["port_cpu_metrics"]
    for k, bar in chip_smoke.EVAL_REL_BARS.items():
        assert abs(port[k] - ref[k]) / abs(ref[k]) <= bar / 5, k
    for k in chip_smoke.EVAL_ACCURACIES:
        assert abs(port[k] - ref[k]) * 122 <= chip_smoke.EVAL_NOTES_BAR, k
    assert d["roundtrip"]["pitch"] == make.ROUNDTRIP_PITCH == 60


def test_port_roundtrip_snr_on_cpu_matches_the_file(capsys):
    import json
    import re
    import sys

    sys.path.insert(0, ROOT)
    import make_torch_reference_data as make
    from gansynth_tpu_torch import cli

    with open(make.EVAL_OUT) as f:
        want = json.load(f)["roundtrip"]["snr_db"]
    assert cli.main(["roundtrip", "--pitch", "60", "--device", "cpu"]) == 0
    got = float(re.search(r"roundtrip SNR: (-?[0-9.]+) dB",
                          capsys.readouterr().out).group(1))
    assert abs(got - want) <= 0.01
