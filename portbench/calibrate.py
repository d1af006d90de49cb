"""The readings a cell's limits are set from, on the card, at the cell's
own size, in one process:

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
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def train_rows(ctx_of, seeds, control):
    import torch

    from portbench import device as devmod, harness
    from portbench.reference.quantize import bf16, fp8

    tc = harness.load_module(REPO / "portbench" / "drivers" /
                             "train_cached.py")
    for i, seed in enumerate(seeds):
        ctx = ctx_of(seed)
        steps = ctx.workload["traffic"]["check_steps"]
        prog = tc.Program(ctx)
        readings = prog.first_steps(steps)
        step0 = prog.step0
        del prog
        devmod.free(ctx.device)
        ref32 = tc.reference_readings(ctx, step0, steps)
        row = {"seed": seed, "program": tc.compare(readings, ref32),
               "worst": tc.worst_leaves(readings, ref32),
               "leaves": tc.gaps(readings, ref32, True),
               "losses": [readings["d_loss"], ref32["d_loss"],
                          readings["g_loss"], ref32["g_loss"]]}
        if i < control:
            for name, kw in (("control", {"q": fp8}), ("half", {"half": True}),
                             ("bf16", {"q": bf16})):
                other = tc.reference_readings(ctx, step0, steps, **kw)
                row[name] = tc.compare(other, ref32)
                row[name + "_worst"] = tc.worst_leaves(other, ref32)
                row[name + "_leaves"] = tc.gaps(other, ref32, True)
            frozen = dict(readings, **{
                k: {n: torch.zeros_like(v) for n, v in readings[k].items()}
                for k in readings if k.startswith(("grad_", "change_"))})
            row["frozen"] = tc.compare(frozen, ref32)
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        yield row


def serve_rows(ctx_of, seeds, control, seconds):
    from portbench import harness, traffic
    from portbench.reference import nets, serve as ref
    from portbench.reference.quantize import fp8
    from portbench import inputs

    hs = harness.load_module(REPO / "portbench" / "drivers" /
                             "http_serve.py")
    ctx = ctx_of(seeds[0])
    cfg, t = ctx.config, ctx.workload["traffic"]
    service, server, thread, stage = hs.start_service(cfg, ctx.device)
    port = server.server_address[1]
    hs.warm_http(port, service.batch_ladder)
    import torch

    params, _, _ = inputs.load_npz(cfg["weights"])
    p = {nets.npz_key(k): torch.from_numpy(v).to(ctx.device)
         for k, v in params.items()}
    try:
        for i, seed in enumerate(seeds):
            sched = traffic.schedule(t, seed, seconds)
            res = hs.drive(port, sched, t, seconds, False)
            picked = hs.sample(res, sched, seed, t["reference_sample"])
            gaps = hs.note_gaps(cfg, picked, stage, ctx.device)
            row = {"seed": seed, "program": hs.numbers(gaps),
                   "summary": hs.summarize(res, seconds, 6e4),
                   "notes": len(gaps["wave"])}
            if i < control:
                bodies = []
                for req, _ in picked:
                    w = ref.render(cfg, p, ref.note_seeds(
                        req["seed"], len(req["pitches"])), req["pitches"],
                        stage, ctx.device, q=fp8)
                    bodies.append(ref.pcm(w))
                row["control"] = hs.numbers(hs.note_gaps(
                    cfg, picked, stage, ctx.device, bodies=bodies))
            yield row
    finally:
        hs.stop_service(service, server, thread)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from portbench import harness

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

    if workload["driver"] == "train_cached":
        rows = train_rows(ctx_of, args.seeds, args.control)
    else:
        rows = serve_rows(ctx_of, args.seeds, args.control, args.seconds)
    kept = []
    for row in rows:
        kept.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(kept, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
