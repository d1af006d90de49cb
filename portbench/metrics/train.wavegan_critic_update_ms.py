"""``train.wavegan_critic_update_ms``: the device ms of one critic update
(its three critic passes, the penalty's second order and its Adam): the
``critic`` phase's device ns over the window (``StepPhases``, the marks
the step's graph replays) over the critic updates the device counted
there. None where the program counts no critic updates."""


def read(facts):
    phases = facts.get("phases") or {}
    if not phases.get("critic_updates"):
        return None
    return phases["critic_ns"] / phases["critic_updates"] / 1e6
