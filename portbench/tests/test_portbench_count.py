"""The frozen counts: K3's bound and the networks' FLOPs, counted by hand
layer by layer at a small stage of the flagship's widths."""

import pytest

from portbench import harness
from portbench.count import flops, peaks

MODEL = harness.load_json(harness.HERE / "configs" /
                          "gansynth-mel-hires-train.json")["model"]


def test_k3_bound_is_chip_smokes():
    f, b = flops.dblock_work(MODEL, 8)
    seconds, by = peaks.bound(f, b, peaks.BF16_PEAK_FLOPS)
    assert by == "operations"
    assert 1e3 * seconds == pytest.approx(0.2345078, rel=1e-6)
    # [8, 128, 1024, 64] -> 128: two 3x3 convs, 2 operations a MAC.
    assert f == 2.0 * 8 * 128 * 1024 * 9 * 64 * (64 + 128)


def test_generator_flops_by_hand_at_stage_1():
    # widths 256 at stages 0 and 1; grids 2 x 16 and 4 x 32.
    mac = (317 * 8192                       # latent dense
           + 2 * 9 * 256 * 256 * 2 * 16      # block 0: two 3x3 convs
           + 4 * 256 * 256 * 4 * 32          # block 1: upsampling conv
           + 9 * 256 * 256 * 4 * 32          # block 1: conv1
           + 256 * 2 * 4 * 32                # toRGB 1
           + 256 * 2 * 2 * 16)               # toRGB 0 (the fade)
    assert flops.generator_flops(MODEL, 1) == 2.0 * mac


def test_critic_flops_by_hand_at_stage_1():
    mac = (2 * 256 * 4 * 32                  # fromRGB 1
           + 2 * 9 * 256 * 256 * 4 * 32      # block 1: two 3x3 convs
           + 2 * 256 * 2 * 16                # fromRGB 0 (the skip)
           + 9 * 257 * 256 * 2 * 16          # final conv over 256 + 1
           + 2 * 16 * 256 * 256              # final dense
           + 256 + 256 * 61)                 # the two heads
    assert flops.critic_flops(MODEL, 1) == 2.0 * mac


def test_stage_6_totals():
    g, d = flops.generator_flops(MODEL, 6), flops.critic_flops(MODEL, 6)
    assert g == pytest.approx(55.177e9, rel=1e-4)
    assert d == pytest.approx(83.744e9, rel=1e-4)
    assert flops.train_step_flops(MODEL, 6, 8) == 8 * (4 * g + 14 * d)


def test_synthesis_bound_is_bytes_bound_at_16():
    seconds, by = peaks.synthesis_bound(16, 128, 1024, 1024, 2046)
    assert by == "bytes"
    assert seconds > 0
