"""``train.wavegan_mfu``: WaveGAN's model FLOPs of the traced steps
(``count/wavegan_flops.py``) over the traced window, as a share of the
bf16 dense peak."""

from portbench.count import wavegan_flops
from portbench.readers import share_of_peak


def read(facts):
    if not facts.get("steps"):
        return None
    work = facts["steps"] * wavegan_flops.train_step_flops(
        facts["model"], facts["batch"], facts["critic_updates"])
    return share_of_peak(work, facts["window_s"])
