"""The readings a ``train_wavegan`` cell's limits are set from
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
    tw = harness.load_module(HERE / "drivers" / "train_wavegan.py")
    for i, seed in enumerate(seeds):
        ctx = ctx_of(seed)
        steps = ctx.workload["traffic"]["check_steps"]
        prog = tw.Program(ctx)
        readings = prog.first_steps(steps)
        del prog
        devmod.free(ctx.device)
        ref32 = tw.reference_readings(ctx, steps)
        row = {"seed": seed, "program": tw.compare(readings, ref32),
               "worst": tw.worst_leaves(readings, ref32),
               "losses": [readings["d_loss"], ref32["d_loss"],
                          readings["g_loss"], ref32["g_loss"]]}
        if i < control:
            for name, kw in (("control", {"q": fp8}), ("half", {"half": True}),
                             ("bf16", {"q": bf16})):
                other = tw.reference_readings(ctx, steps, **kw)
                row[name] = tw.compare(other, ref32)
                row[name + "_worst"] = tw.worst_leaves(other, ref32)
            frozen = dict(readings, **{
                k: {n: torch.zeros_like(v) for n, v in readings[k].items()}
                for k in readings if k.startswith(("grad_", "change_"))})
            row["frozen"] = tw.compare(frozen, ref32)
        if torch.device(ctx.device).type == "cuda":
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
        yield row
