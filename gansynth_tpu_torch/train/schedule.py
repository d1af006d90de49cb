"""Progressive growth schedule: global step -> (stage, fade alpha)
(SURVEY.md §2.4 G3, §3.4). A copy of ``gansynth_tpu/train/schedule.py``,
which imports no JAX.

Behavioral contract (the [E]-grade part): each stage > 0 has a fade-in
interval (alpha ramping 0 -> 1 linearly with the global step) followed by a
stabilization interval (alpha = 1); stage 0 has no fade. The rebuild keys
the schedule off the global step in a single training run (the reference
family's continuous-growth idiom) but compiles one step function per stage
— ``stage`` is a static Python int, ``alpha`` a traced scalar, so the fade
itself never recompiles (SURVEY.md §7 step 4).

``fade_steps`` / ``stable_steps`` may be scalars (uniform ladder, the
reference behavior) or per-stage sequences (compressed schedules that
spend more steps at the cheap low resolutions); entry ``s`` applies to
stage ``s`` (the stage-0 fade entry is ignored — stage 0 never fades).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple, Union

StepSpec = Union[int, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    num_stages: int = 7
    fade_steps: StepSpec = 800_000
    stable_steps: StepSpec = 800_000

    def _per_stage(self, spec: StepSpec, stage: int) -> int:
        if isinstance(spec, int):
            return spec
        if len(spec) != self.num_stages:
            raise ValueError(
                f"per-stage schedule needs {self.num_stages} entries, "
                f"got {len(spec)}"
            )
        return int(spec[stage])

    def fade(self, stage: int) -> int:
        """Fade-in steps for ``stage`` (0 for stage 0 — never fades)."""
        return 0 if stage == 0 else self._per_stage(self.fade_steps, stage)

    def stable(self, stage: int) -> int:
        return self._per_stage(self.stable_steps, stage)

    def stage_and_alpha(self, step: int) -> Tuple[int, float]:
        """(stage, alpha) at a global step. Pure Python — drives the outer
        loop; alpha is re-derived identically on restore. Past the end of
        the ladder, training continues at the top stage with alpha=1."""
        for stage, start, end in self.stage_boundaries():
            if step < end:
                within = step - start
                fade = self.fade(stage)
                if fade and within < fade:
                    return stage, min(1.0, (within + 1) / fade)
                return stage, 1.0
        return self.num_stages - 1, 1.0

    def total_steps(self) -> int:
        """Steps to finish the whole ladder (end of last stabilization)."""
        return sum(self.fade(s) + self.stable(s)
                   for s in range(self.num_stages))

    def stage_boundaries(self) -> Iterator[Tuple[int, int, int]]:
        """Yields (stage, start_step, end_step) segments in order."""
        start = 0
        for s in range(self.num_stages):
            end = start + self.fade(s) + self.stable(s)
            yield s, start, end
            start = end

    def steps_until_stage_change(self, step: int) -> int:
        """Steps (>=1) from ``step`` to the next stage boundary — the
        longest chunk a fused multi-step program may run without a
        recompile-worthy stage switch. Infinite past the ladder end
        (returned as a large int)."""
        for _, _, end in self.stage_boundaries():
            if step < end:
                return end - step
        return 2**62


def schedule_from_config(config) -> ProgressiveSchedule:
    """Build the schedule from a Config (per-stage tuples win when set).
    WaveGAN (``model.architecture``) does not grow: one stage, at alpha 1,
    for ``stable_steps``."""
    t = config.train
    if config.model.architecture == "wavegan":
        return ProgressiveSchedule(num_stages=1, fade_steps=0,
                                   stable_steps=t.stable_steps)
    return ProgressiveSchedule(
        num_stages=config.model.num_stages,
        fade_steps=(t.stage_fade_steps if t.stage_fade_steps is not None
                    else t.fade_steps),
        stable_steps=(t.stage_stable_steps if t.stage_stable_steps is not None
                      else t.stable_steps),
    )
