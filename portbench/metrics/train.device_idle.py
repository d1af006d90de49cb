"""``train.device_idle``: Share of the traced superstep's wall time with no work on the device."""

from portbench.readers import device_idle as read  # noqa: F401
