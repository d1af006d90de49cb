"""``train.mfu``: Model FLOPs of the traced window's steps over its seconds, as a share of the bf16 peak."""

from portbench.readers import train_mfu as read  # noqa: F401
