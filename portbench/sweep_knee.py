"""Finds the knee of an open-loop serving cell: the highest mean rate at
which the service refuses and times out nothing and its backlog does not
grow over a window. Runs the cell's own traffic (its workload file, the
rate replaced) at each rate for ``--seconds`` against one service.

    python3 portbench/sweep_knee.py --workload serve.paced-bursty
        --rates 400 500 600 --seconds 20 --seed 1

The backlog grows when the last quarter of the window waits longer than
its first (median latency over twice) or the requests still open at the
window's close take over a second to finish. Prints one JSON line a
rate; the cell then runs at 0.8 of the knee, written into its file by
hand with the table (PERF.md).
"""

import argparse
import copy
import json
import math
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def backlog(res, seconds):
    """``(first-quarter median ms, last-quarter median ms, drain s)``."""
    t0 = res["t0"]
    recs = [r for r in res["records"] if r[6] == 200]
    q = seconds / 4

    def med(lo, hi):
        v = [(r[5] - r[3]) * 1e3 for r in recs if lo <= r[3] - t0 < hi]
        return float(np.median(v)) if v else math.nan

    drain = max((r[5] for r in res["records"]), default=t0) - (t0 + seconds)
    return med(0, q), med(3 * q, seconds), max(0.0, drain)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    from portbench import harness, traffic

    here = REPO / "portbench"
    workload = harness.load_json(here / "workloads" /
                                 f"{args.workload}.json")
    config = harness.load_json(here / "configs" /
                               f"{workload['config']}.json")
    hs = harness.load_module(here / "drivers" / "http_serve.py")
    service, server, thread, _ = hs.start_service(config, "cuda")
    port = server.server_address[1]
    hs.warm_http(port, service.batch_ladder)
    knee = None
    try:
        for rate in args.rates:
            t = copy.deepcopy(workload["traffic"])
            t["rate_notes_per_s"] = rate
            sched = traffic.schedule(t, args.seed, args.seconds)
            res = hs.drive(port, sched, t, args.seconds, False)
            s = hs.summarize(res, args.seconds, 1e3 * t["client_timeout_s"])
            first, last, drain = backlog(res, args.seconds)
            grows = not (last <= 2 * first) or drain > 1.0
            row = {"rate_notes_per_s": rate, **s,
                   "first_quarter_p50_ms": first,
                   "last_quarter_p50_ms": last, "drain_s": drain,
                   "backlog_grows": grows}
            print(json.dumps(row), flush=True)
            if s["failed"] == 0 and not grows:
                knee = rate
    finally:
        hs.stop_service(service, server, thread)
    print(json.dumps({"knee_notes_per_s": knee,
                      "cell_rate_notes_per_s": None if knee is None
                      else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
