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
