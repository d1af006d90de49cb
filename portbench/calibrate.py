"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process, by ``calibration/<driver>.py`` for the cell's
driver (``rows(ctx_of, seeds, control, seconds)``):

- the program over many seeds (its compared numbers against the float32
  reference: the lower readings);
- the control on the first ``--control`` seeds: the reference computed
  at float8 (``reference/quantize.py``) in the program's place, against
  the float32 reference (the upper readings);
- training only, the planted fault "half of the batch left out" in the
  reference on the same seeds (a state left unchanged reads 1 on
  ``change_median`` without a run), and the reference at bfloat16, a
  second witness of what the program's precision alone gives.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ...
        [--control 3] [--seconds 5] [--out readings.json]

A serving cell runs its own traffic for ``--seconds`` a seed against one
service. Prints one JSON line a seed; ``--out`` keeps them all.

A configuration with a driver of its own joins as new files: its
``calibration/<driver>.py`` beside its driver, narrow copy, configuration,
workload and readers, and entries in BENCHMARK.json; it edits no file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402


def control_rows(driver: str, here: Path = REPO / "portbench"):
    """``rows(ctx_of, seeds, control, seconds)`` of
    ``calibration/<driver>.py`` under ``here``: one row a seed."""
    path = here / "calibration" / f"{driver}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"driver {driver!r} has no control readings: {path} is missing")
    return harness.load_module(path).rows


def train_rows(ctx_of, seeds, control):
    return control_rows("train_cached")(ctx_of, seeds, control, None)


def serve_rows(ctx_of, seeds, control, seconds):
    return control_rows("http_serve")(ctx_of, seeds, control, seconds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    man = harness.manifest()
    entry = harness.cell(man, args.workload)
    here = REPO / "portbench"
    workload = harness.load_json(here / "workloads" /
                                 f"{args.workload}.json")
    config = harness.load_json(here / "configs" /
                               f"{entry['config']}.json")

    def ctx_of(seed):
        return harness.Context(args.workload, workload, config, seed,
                               args.seconds, False, time.time())

    rows = control_rows(workload["driver"], here)(
        ctx_of, args.seeds, args.control, args.seconds)
    kept = []
    for row in rows:
        kept.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(kept, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
