"""``correct`` comes out false when the timed path is broken underneath:
a narrow run of each cell on the CPU (the look for a card skipped) with
each fault the cell can have planted in the program, and with the
control, the reference at float8 in the program's place."""

import math

import pytest
import torch

from portbench import harness
from portbench.reference import serve as ref_serve
from portbench.reference.quantize import fp8
from portbench.tests import tiny


def test_a_step_that_leaves_its_state_unchanged(tmp_path, monkeypatch):
    from gansynth_tpu_torch.train import step

    def frozen(self, state, rows, *args, **kwargs):
        return {k: torch.tensor(0.0) for k in self.names}

    monkeypatch.setattr(step._StepProgram, "run", frozen)
    result = tiny.run("train.s6-cached", tmp_path)
    assert not result["correct"]
    assert result["checks"]["change_median"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from gansynth_tpu_torch.train import losses

    def first_half(fn):
        def f(*tensors):
            return fn(*(t[:len(t) // 2] for t in tensors))
        return f

    for name in ("wgan_critic_loss", "drift_penalty", "pitch_cross_entropy",
                 "generator_adversarial_loss", "penalty_from_grads"):
        monkeypatch.setattr(losses, name, first_half(getattr(losses, name)))
    result = tiny.run("train.s6-cached", tmp_path)
    assert not result["correct"]


def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    from gansynth_tpu_torch.synth import sampler

    forward = sampler.SeededProgram.forward
    monkeypatch.setattr(sampler.SeededProgram, "forward",
                        lambda self, seeds, pitch: forward(self, seeds ^ 1,
                                                           pitch))
    result = tiny.run("serve.single-client", tmp_path)
    assert not result["correct"]


def test_half_a_served_batch_left_out(tmp_path, monkeypatch):
    from gansynth_tpu_torch.synth import sampler

    forward = sampler.SeededProgram.forward

    def half(self, seeds, pitch):
        # every other row: the batch's tail is the rung's padding
        out = forward(self, seeds, pitch)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(sampler.SeededProgram, "forward", half)
    # a batch of one note has no half to leave out: four clients sending
    # four notes a request fill batches of several
    result = tiny.run("serve.single-client", tmp_path, traffic={
        "clients": 4, "notes_weights": {"1": 0.0, "4": 1.0},
        "keep": {"per_client": 1}})
    assert not result["correct"]


def test_the_training_control_fails(tmp_path):
    cfg, wl = tiny.overrides("train.s6-cached", tmp_path)
    ctx = _ctx("train.s6-cached", cfg, wl)
    tc = harness.load_module(harness.HERE / "drivers" / "train_cached.py")
    steps = ctx.workload["traffic"]["check_steps"]
    reference = tc.reference_readings(ctx, 415000, steps)
    control = tc.reference_readings(ctx, 415000, steps, q=fp8)
    numbers = tc.compare(control, reference)
    limits = ctx.workload["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_the_serving_control_fails(tmp_path):
    cfg, wl = tiny.overrides("serve.single-client", tmp_path)
    ctx = _ctx("serve.single-client", cfg, wl)
    hs = harness.load_module(harness.HERE / "drivers" / "http_serve.py")
    params, _, stage = __import__("portbench.inputs").inputs.load_npz(
        ctx.config["weights"])
    from portbench.reference import nets

    p = {nets.npz_key(k): torch.from_numpy(v) for k, v in params.items()}
    picked = [({"pitches": [24 + 7 * i], "seed": 1000 + i}, None)
              for i in range(8)]
    bodies = [ref_serve.pcm(ref_serve.render(
        ctx.config, p, ref_serve.note_seeds(r["seed"], 1), r["pitches"],
        stage, "cpu", q=fp8)) for r, _ in picked]
    numbers = hs.numbers(hs.note_gaps(ctx.config, picked, stage, "cpu",
                                      bodies=bodies))
    limits = ctx.workload["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers
    assert all(math.isfinite(v) for v in numbers.values())


def _ctx(cell, cfg, wl):
    workload = harness._merge(harness.load_json(
        harness.HERE / "workloads" / f"{cell}.json"), wl)
    config = harness._merge(harness.load_json(
        harness.HERE / "configs" / f"{workload['config']}.json"), cfg)
    return harness.Context(cell, workload, config, tiny.SEED, 2.0, False,
                           0.0, "cpu")
