"""What the per-layer readers (``metrics/<metric>.py``) share. Each takes
the ``facts`` of a traced run and returns a number, or None when the
trace holds nothing to read."""

from __future__ import annotations

from typing import Mapping, Optional

from portbench.count import flops, peaks
from portbench.tracing import port_kernel_totals


def device_idle(facts: Mapping) -> Optional[float]:
    """Percent of the traced window in which the device ran nothing."""
    if not facts.get("window_s") or not facts.get("busy_s"):
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["window_s"])


def share_of_peak(work_flops: float, seconds: float) -> Optional[float]:
    """Percent of the card's bf16 dense peak that ``work_flops`` done in
    ``seconds`` reach."""
    if work_flops <= 0 or seconds <= 0:
        return None
    return 100.0 * work_flops / seconds / peaks.BF16_PEAK_FLOPS


def train_mfu(facts: Mapping) -> Optional[float]:
    if not facts.get("steps"):
        return None
    work = facts["steps"] * flops.train_step_flops(
        facts["model"], facts["stage"], facts["batch"])
    return share_of_peak(work, facts["window_s"])


def serve_mfu(facts: Mapping) -> Optional[float]:
    if not facts.get("notes"):
        return None
    work = facts["notes"] * flops.generator_flops(facts["model"],
                                                  facts["stage"])
    return share_of_peak(work, facts["window_s"])


def dblock_roofline(facts: Mapping) -> Optional[float]:
    """K3's launches, each charged one call at the configuration's final
    stage and batch, over their device time: percent of the bound."""
    count, seconds = port_kernel_totals(facts["kernels"], "dblock")
    if not count or seconds <= 0:
        return None
    f, b = flops.dblock_work(facts["model"], facts["batch"])
    bound_s, _ = peaks.bound(f, b, peaks.BF16_PEAK_FLOPS)
    return 100.0 * count * bound_s / seconds


def notes_per_batch(facts: Mapping) -> Optional[float]:
    """Notes answered between the two ``/healthz`` readings over the
    device batches the service counted between them."""
    if not facts.get("batches"):
        return None
    return facts["batch_notes"] / facts["batches"]
