"""``train.k3_roofline``: K3 (dblock_nhwc_) launches against their bound."""

from portbench.readers import dblock_roofline as read  # noqa: F401
