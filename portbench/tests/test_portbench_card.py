"""On the card (skipped without one): every cell runs end to end and
reads correct, and at each cell's own size the control, the reference
at float8 in the program's place, fails a compared number where the
program passes them all."""

import json
import subprocess
import sys

import pytest

from portbench import harness

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", cell,
         "--seed", str((1 << 31) + 77), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    sys.path.insert(0, str(harness.HERE))
    import calibrate

    workload = harness.load_json(harness.HERE / "workloads" /
                                 f"{cell}.json")
    config = harness.load_json(harness.HERE / "configs" /
                               f"{harness.cell(MAN, cell)['config']}.json")

    def ctx_of(seed):
        return harness.Context(cell, workload, config, seed, 3.0, False,
                               0.0)

    seeds = [(1 << 31) + 91]
    rows = (calibrate.train_rows(ctx_of, seeds, 1)
            if workload["driver"] == "train_cached"
            else calibrate.serve_rows(ctx_of, seeds, 1, 3.0))
    row = next(iter(rows))
    limits = workload["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items())
