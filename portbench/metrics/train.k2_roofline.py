"""``train.k2_roofline``: K2 (conv3x3_nhwc_) launches in the traced superstep, each charged its own shape's bound, over their device time: percent of the bound.

The shapes come from the program's record of K2's launches by ``(role,
B, H, W, C_in, C_out)`` (``kernels.launch_shapes``), which counts every
launch of the process, graph replays included. Every step of a run is
the same step, so the record's mix of shapes is each step's: the trace's
launches over its ``steps`` steps are charged in the record's
proportions, and each proportion has to be a whole number of launches a
step. The bound charged is bf16's (its peak, 2-byte operands).

None when the port keeps no record (versions before it), when the mix is
not whole, when the trace holds K2's float32 kernel or no K2 device time.
"""

from fractions import Fraction

from portbench.count import peaks
from portbench.count.conv3x3 import conv3x3_work
from portbench.tracing import port_kernel_totals

K2_F32 = "conv3x3_nhwc_f32"   # K2's float32 device function (kernels/csrc)


def recorded_shapes():
    """The program's record, or None for a port that keeps none."""
    from gansynth_tpu_torch import kernels

    record = getattr(kernels, "launch_shapes", None)
    return None if record is None else record()


def roofline(facts, shapes):
    kernels = facts["kernels"]
    if not shapes or any(K2_F32 in name for name in kernels):
        return None
    count, seconds = port_kernel_totals(kernels, "conv3x3")
    steps = facts.get("steps") or 0
    if not steps or count % steps or seconds <= 0:
        return None
    per_step, total = count // steps, sum(shapes.values())
    bound_s = 0.0
    for shape, n in shapes.items():
        launches = Fraction(n * per_step, total)
        if launches.denominator != 1:
            return None
        bound_s += int(launches) * peaks.bound(*conv3x3_work(*shape[1:]),
                                               peaks.BF16_PEAK_FLOPS)[0]
    return 100.0 * steps * bound_s / seconds


def read(facts):
    return roofline(facts, recorded_shapes())
