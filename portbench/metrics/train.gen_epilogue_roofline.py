"""``train.gen_epilogue_roofline``: K4 (gen_epilogue_) launches in the traced superstep, each charged its own shape's byte floor at the HBM peak, over their device time: percent of the bound.

K4's device functions are found by their own prefix in the trace: the
forward (``gen_epilogue_fwd_``) and backward (``gen_epilogue_bwd_``)
launches are counted, and their device time and that of the backward's
bias sums (``gen_epilogue_bias_sum_``) are charged. The shapes come from
the program's record of K4's launches by ``(role, B, H, W, C)``
(``kernels.gen_epilogue_shapes``), which counts every launch of the
process, graph replays included. Every step of a run is the same step,
so the record's mix is each step's: the trace's launches over its
``steps`` steps are charged in the record's proportions, and each
proportion has to be a whole number of launches a step. The floor is
bf16's (``count/gen_epilogue.py``) at ``count/peaks.py``'s HBM rate.

None when the port keeps no record (versions before K4), when the mix is
not whole, when the trace holds K4's float32 kernels or no K4 device
time.
"""

from fractions import Fraction

from portbench.count import peaks
from portbench.count.gen_epilogue import epilogue_bytes

PREFIX = "gen_epilogue_"
LAUNCHES = ("gen_epilogue_fwd_", "gen_epilogue_bwd_")


def recorded_shapes():
    """The program's record, or None for a port that keeps none."""
    from gansynth_tpu_torch import kernels

    record = getattr(kernels, "gen_epilogue_shapes", None)
    return None if record is None else record()


def roofline(facts, shapes):
    k4 = {name: v for name, v in facts["kernels"].items() if PREFIX in name}
    if not shapes or any("_f32" in name for name in k4):
        return None
    count = sum(v["count"] for name, v in k4.items()
                if any(p in name for p in LAUNCHES))
    seconds = sum(v["seconds"] for v in k4.values())
    steps = facts.get("steps") or 0
    if not steps or count % steps or seconds <= 0:
        return None
    per_step, total = count // steps, sum(shapes.values())
    bound_s = 0.0
    for shape, n in shapes.items():
        launches = Fraction(n * per_step, total)
        if launches.denominator != 1:
            return None
        bound_s += int(launches) * epilogue_bytes(*shape) \
            / peaks.HBM_BYTES_PER_S
    return 100.0 * steps * bound_s / seconds


def read(facts):
    return roofline(facts, recorded_shapes())
