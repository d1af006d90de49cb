"""The training step's phase marks (``csrc/step_marks.cu``) and their plain
version.

A mark is one of the five boundaries of a step (:data:`MARKS`). It adds
the time since the previous mark to one phase's total (:data:`PHASES`,
the order of the totals' slots) and keeps its own time as the last; the
``end`` mark also counts the step, and the ``critic`` mark, which ends
each critic update, the critic updates (:data:`CRITICS`). ``start`` adds to ``between`` (the gap
since the previous step's end), unless no mark has run yet. The anchor
(:data:`ANCHOR`, passed where a mark is) sets the last mark's time to now
and adds nothing, so the next mark counts only from it.

For a CUDA tensor :func:`step_mark` launches the mark's one-thread kernel
on the current stream (a CUDA graph captures it with the step, so every
replay runs it), timed by the device's own clock; for a CPU tensor it
calls :func:`step_mark_plain`, which takes ``time.perf_counter_ns()`` (an
eager step on the CPU is synchronous). There is no fallback from one to
the other. Nothing is built at import time.
"""

from __future__ import annotations

import time

import torch

from gansynth_tpu_torch.kernels._build import I32, PTR, launch, symbol

MARKS = ("start", "frontend", "critic", "generator", "end")
ANCHOR = len(MARKS)   # the kernel step_mark_anchor
PHASES = ("frontend", "critic", "generator", "ema", "between")
STEPS, LAST, CRITICS = len(PHASES), len(PHASES) + 1, len(PHASES) + 2
SLOTS = len(PHASES) + 3


def phase_ended(mark: int) -> int:
    """The slot of the phase that ``MARKS[mark]`` ends: ``start`` ends
    ``between``, ``end`` ends ``ema``, every other mark its namesake."""
    return PHASES.index({"start": "between", "end": "ema"}.get(
        MARKS[mark], MARKS[mark]))


def new_totals(device) -> torch.Tensor:
    """Zeroed totals (int64 ``[SLOTS]``: the phases' ns, the steps, the
    last mark's time, the critic updates) on ``device``."""
    return torch.zeros(SLOTS, dtype=torch.int64, device=device)


def step_mark_plain(totals: torch.Tensor, mark: int) -> None:
    """The kernel's arithmetic on the host's clock."""
    now = time.perf_counter_ns()
    if mark == ANCHOR:
        totals[LAST] = now
        return
    last = int(totals[LAST])
    if last:
        totals[phase_ended(mark)] += now - last
    if MARKS[mark] == "end":
        totals[STEPS] += 1
    if MARKS[mark] == "critic":
        totals[CRITICS] += 1
    totals[LAST] = now


def _entry():
    return symbol("step_marks", "step_mark", [I32, PTR, PTR])


def step_mark(totals: torch.Tensor, mark: int) -> None:
    """Mark ``MARKS[mark]`` (or the :data:`ANCHOR`) into ``totals`` (from
    :func:`new_totals`): a launch of its kernel for a CUDA tensor,
    :func:`step_mark_plain` for a CPU tensor."""
    if totals.dtype != torch.int64 or totals.shape != (SLOTS,) \
            or not totals.is_contiguous():
        raise ValueError(f"step_mark needs contiguous int64 [{SLOTS}] "
                         f"totals, got {totals.dtype} {tuple(totals.shape)}")
    if not 0 <= mark <= ANCHOR:
        raise ValueError(f"no mark {mark}")
    if totals.device.type == "cpu":
        step_mark_plain(totals, mark)
        return
    if totals.device.type != "cuda":
        raise ValueError(f"step_mark: unsupported device {totals.device}")
    launch("step mark", _entry(), totals.device, mark, totals)
