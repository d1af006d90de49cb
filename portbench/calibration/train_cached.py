"""The readings a ``train_cached`` cell's limits are set from
(``calibrate.py``): the program's compared numbers against the float32
reference on each seed; on the first ``control`` seeds, the reference at
float8 (the control), with half of the batch left out, and at bfloat16,
and a state left unchanged."""

from pathlib import Path

import torch

from portbench import device as devmod, harness
from portbench.reference.quantize import bf16, fp8

HERE = Path(__file__).resolve().parents[1]


def rows(ctx_of, seeds, control, seconds=None):
    """One row a seed. ``seconds`` is not read: the readings of a
    training cell need no measured window."""
    tc = harness.load_module(HERE / "drivers" / "train_cached.py")
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
