"""``train.k2_roofline``: K2's bound at its shapes (``count/conv3x3.py``)
against the one-off bounds of ``chip_smoke.py``, its reader on facts and
records made by hand, with the cases where it reads nothing, its entry in
the manifest, and (on the card, skipped without one) a traced run of
``train.s6-cached`` that reports it."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.count import peaks
from portbench.count.conv3x3 import conv3x3_work

# PERF.md section 6's K2 rows (chip_smoke.py's bounds): [B, H, W, C_in] ->
# C_out, bound ms, bound by.
K2_ROWS = [((8, 64, 512, 128, 256), 0.156339, "operations"),
           ((8, 64, 512, 256, 128), 0.156339, "operations"),
           ((8, 64, 512, 128, 128), 0.0781693, "operations"),
           ((8, 32, 256, 256, 256), 0.0781693, "operations"),
           ((8, 16, 128, 256, 256), 0.0195423, "operations"),
           ((3, 64, 512, 128, 128), 0.0293135, "operations"),
           ((3, 32, 256, 256, 256), 0.0293135, "operations"),
           ((3, 16, 128, 256, 256), 0.00732837, "operations"),
           ((8, 128, 1024, 64, 64), 0.080152, "bytes")]


@pytest.mark.parametrize("shape,ms,by", K2_ROWS)
def test_k2_bound_is_chip_smokes(shape, ms, by):
    seconds, bound_by = peaks.bound(*conv3x3_work(*shape),
                                    peaks.BF16_PEAK_FLOPS)
    assert bound_by == by
    assert 1e3 * seconds == pytest.approx(ms, rel=1e-5)


READER = harness.load_module(harness.HERE / "metrics" /
                             "train.k2_roofline.py")
HEADLINE = ("forward", 8, 64, 512, 128, 256)
DX = ("input_grad", 8, 64, 512, 256, 128)


def _facts(count, seconds, steps=2):
    """A traced superstep of ``steps`` steps: K2 under two template
    instances, and a kernel that is not K2."""
    return {"steps": steps, "kernels": {
        "void conv3x3_nhwc_bf16_wgmma<256>(...)":
        {"count": count - 1, "seconds": seconds * 0.75},
        "void conv3x3_nhwc_bf16_wgmma<128>(...)":
        {"count": 1, "seconds": seconds * 0.25},
        "void step_mark_critic(long long*)": {"count": steps,
                                              "seconds": 1e-6}}}


def _bound(shape):
    return peaks.bound(*conv3x3_work(*shape[1:]), peaks.BF16_PEAK_FLOPS)[0]


def test_k2_roofline_charges_each_launch_its_shapes_bound():
    # a record of 30 steps of 3 headline launches and 1 dx launch each;
    # the trace holds 2 steps of them: 8 launches in 2.5 ms
    record = {HEADLINE: 90, DX: 30}
    got = READER.roofline(_facts(8, 2.5e-3), record)
    assert got == pytest.approx(100.0 * 8 * _bound(HEADLINE) / 2.5e-3)
    assert got == pytest.approx(50.02848, rel=1e-5)


def test_k2_roofline_reads_the_programs_record(monkeypatch):
    from gansynth_tpu_torch import kernels

    monkeypatch.setattr(kernels, "launch_shapes",
                        lambda: {HEADLINE: 6, DX: 2})
    assert READER.read(_facts(8, 2.5e-3)) == pytest.approx(50.02848,
                                                           rel=1e-5)
    # a port that keeps no record
    monkeypatch.delattr(kernels, "launch_shapes")
    assert READER.read(_facts(8, 2.5e-3)) is None


def test_k2_roofline_reads_nothing_it_cannot_match():
    record = {HEADLINE: 90, DX: 30}
    # the trace's launches are not a whole number a step
    assert READER.roofline(_facts(7, 1e-3), record) is None
    # the record's mix is not a whole number of launches a step
    assert READER.roofline(_facts(10, 1e-3), record) is None
    # no record, no traced step, no K2 launch or no device time
    assert READER.roofline(_facts(8, 1e-3), {}) is None
    assert READER.roofline(_facts(8, 1e-3), None) is None
    assert READER.roofline(_facts(8, 1e-3, steps=0), record) is None
    assert READER.roofline({"steps": 2, "kernels": {}}, record) is None
    assert READER.roofline(_facts(8, 0.0), record) is None
    # K2's float32 kernel, whose bound is not the bf16 one charged here
    f32 = _facts(8, 1e-3)
    f32["kernels"]["conv3x3_nhwc_f32_fma(float const*, float const*, "
                   "float*, int, int, int, int)"] = {"count": 1,
                                                     "seconds": 1e-4}
    assert READER.roofline(f32, record) is None


def test_k2_roofline_names_its_cell():
    man = harness.manifest()
    entry = next(m for m in man["per_layer"]
                 if m["name"] == "train.k2_roofline")
    assert entry["workloads"] == ["train.s6-cached"]
    assert entry["moves"] == "train_step_ms"
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert READER.__doc__.startswith("``train.k2_roofline``: ")


def test_a_traced_run_reports_k2_roofline(card):
    """On the card, beside the per-layer metrics read before it."""
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "train.s6-cached", "--seed", str((1 << 31) + 83), "--seconds", "3",
         "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    for name in ("train.k2_roofline", "train.mfu", "train.device_idle",
                 "train.k3_roofline"):
        assert metrics.get(name, {}).get("value") is not None, name
    assert 0 < metrics["train.k2_roofline"]["value"] < 100
