"""The readings an ``http_serve`` cell's limits are set from
(``calibrate.py``): one service on the card; each seed runs the cell's
own traffic for ``seconds`` against it and holds a sample of the served
notes to the float32 reference; on the first ``control`` seeds the same
notes rendered by the reference at float8 (the control) too."""

from pathlib import Path

import torch

from portbench import harness, inputs, traffic
from portbench.reference import nets, serve as ref
from portbench.reference.quantize import fp8

HERE = Path(__file__).resolve().parents[1]


def rows(ctx_of, seeds, control, seconds):
    """One row a seed."""
    hs = harness.load_module(HERE / "drivers" / "http_serve.py")
    ctx = ctx_of(seeds[0])
    cfg, t = ctx.config, ctx.workload["traffic"]
    service, server, thread, stage = hs.start_service(cfg, ctx.device)
    port = server.server_address[1]
    hs.warm_http(port, service.batch_ladder)
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
