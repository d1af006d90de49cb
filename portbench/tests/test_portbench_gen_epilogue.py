"""``train.gen_epilogue_roofline``: K4's byte floor at one shape
(``count/gen_epilogue.py``) computed by hand, its reader on facts and
records made by hand, with the cases where it reads nothing, its entry in
the manifest, and (on the card, skipped without one) the kernel's own
grid against the floor's partial rows and a traced run of
``train.s6-cached`` that reports it."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.count import peaks
from portbench.count.gen_epilogue import epilogue_bytes, partial_rows

READER = harness.load_module(harness.HERE / "metrics" /
                             "train.gen_epilogue_roofline.py")
# the stage-6 step's largest epilogue and its smallest, [B, H, W, C]
BIG, SMALL = (8, 128, 1024, 64), (8, 2, 16, 256)


def test_byte_floor_by_hand():
    n = 8 * 128 * 1024 * 64                     # 67,108,864 elements
    assert epilogue_bytes("forward", *BIG) == 4 * n + 2 * 64 == 268435584
    assert epilogue_bytes("recompute", *BIG) == 268435584
    # 1,048,576 rows, 8 threads a row: 32 rows a block at once, 4 deep,
    # 8192 chunks, capped at 528 blocks of 64 float32 partial sums
    assert partial_rows(8 * 128 * 1024, 64) == 528
    assert epilogue_bytes("backward", *BIG) == \
        6 * n + 4 * 64 + 2 * 4 * 528 * 64 == 402923776
    # 256 rows, 32 threads a row: 8 rows a block at once, 4 deep
    assert partial_rows(8 * 2 * 16, 256) == 8
    assert epilogue_bytes("backward", *SMALL) == \
        6 * 65536 + 4 * 256 + 2 * 4 * 8 * 256
    with pytest.raises(KeyError):
        epilogue_bytes("input_grad", *BIG)


def _facts(fwd, bwd, seconds, steps=2, f32=False):
    """A traced superstep of ``steps`` steps: K4's forward and backward
    launches under two template instances, the bias sums, and a kernel
    that is not K4."""
    t = "f32" if f32 else "bf16"
    return {"steps": steps, "kernels": {
        f"void gen_epilogue_fwd_{t}<8, 1>(uint4 const*, ...)":
        {"count": fwd, "seconds": seconds * 0.4},
        f"void gen_epilogue_bwd_{t}<8, 1>(uint4 const*, ...)":
        {"count": bwd, "seconds": seconds * 0.5},
        f"gen_epilogue_bias_sum_{t}(float const*, int, int, float*)":
        {"count": bwd, "seconds": seconds * 0.1},
        "void conv3x3_nhwc_bf16_wgmma<256>(...)": {"count": 9,
                                                   "seconds": 1.0}}}


RECORD = {("forward", *BIG): 60, ("backward", *BIG): 30}


def test_roofline_charges_each_launch_its_shapes_floor():
    # 2 steps of 2 forward and 1 backward launches: 6 launches in 1 ms
    got = READER.roofline(_facts(4, 2, 1e-3), RECORD)
    floor = (4 * 268435584 + 2 * 402923776) / peaks.HBM_BYTES_PER_S
    assert got == pytest.approx(100.0 * floor / 1e-3)
    assert got == pytest.approx(56.1071, rel=1e-5)


def test_roofline_reads_the_programs_record(monkeypatch):
    from gansynth_tpu_torch import kernels

    monkeypatch.setattr(kernels, "gen_epilogue_shapes",
                        lambda: {("forward", *BIG): 4, ("backward", *BIG): 2})
    assert READER.read(_facts(4, 2, 1e-3)) == pytest.approx(56.1071,
                                                           rel=1e-5)
    # a port that keeps no record
    monkeypatch.delattr(kernels, "gen_epilogue_shapes")
    assert READER.read(_facts(4, 2, 1e-3)) is None


def test_roofline_reads_nothing_it_cannot_match():
    # the trace's launches are not a whole number a step
    assert READER.roofline(_facts(4, 1, 1e-3), RECORD) is None
    # the record's mix is not a whole number of launches a step
    assert READER.roofline(_facts(2, 2, 1e-3), RECORD) is None
    assert READER.roofline(_facts(4, 2, 1e-3),
                           {("forward", *BIG): 7, ("backward", *BIG): 2}) \
        is None
    # no record, no traced step, no K4 launch or no device time
    assert READER.roofline(_facts(4, 2, 1e-3), {}) is None
    assert READER.roofline(_facts(4, 2, 1e-3), None) is None
    assert READER.roofline(_facts(4, 2, 1e-3, steps=0), RECORD) is None
    assert READER.roofline({"steps": 2, "kernels": {}}, RECORD) is None
    assert READER.roofline(_facts(4, 2, 0.0), RECORD) is None
    # K4's float32 kernels, whose floor is not the bf16 one charged here
    assert READER.roofline(_facts(4, 2, 1e-3, f32=True), RECORD) is None
    mixed = _facts(4, 2, 1e-3)
    mixed["kernels"]["void gen_epilogue_fwd_f32<16, 1>(...)"] = {
        "count": 1, "seconds": 1e-5}
    assert READER.roofline(mixed, RECORD) is None


def test_roofline_names_its_cell():
    man = harness.manifest()
    entry = next(m for m in man["per_layer"]
                 if m["name"] == "train.gen_epilogue_roofline")
    assert entry["workloads"] == ["train.s6-cached"]
    assert entry["moves"] == "train_step_ms" and entry["layer"] == "kernels"
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["source"] == "device_trace"
    assert READER.__doc__.startswith("``train.gen_epilogue_roofline``: ")


STEP_SHAPES = [(8, 2 << i, 16 << i, c)
               for i, c in enumerate((256, 256, 256, 256, 256, 128, 64))]


@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_partial_rows_are_the_kernels_grid(card, shape):
    import ctypes

    from gansynth_tpu_torch.kernels._build import load_library

    fn = load_library("gen_epilogue").lib.gen_epilogue_blocks
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    b, h, w, c = shape
    assert fn(b * h * w, c, 2) == partial_rows(b * h * w, c)


def test_a_traced_run_reports_gen_epilogue_roofline(card):
    """On the card, beside the per-layer metrics read before it."""
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "train.s6-cached", "--seed", str((1 << 31) + 91), "--seconds", "3",
         "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    for name in ("train.gen_epilogue_roofline", "train.k2_roofline",
                 "train.mfu", "train.device_idle", "train.k3_roofline"):
        assert metrics.get(name, {}).get("value") is not None, name
    assert 0 < metrics["train.gen_epilogue_roofline"]["value"] < 100
