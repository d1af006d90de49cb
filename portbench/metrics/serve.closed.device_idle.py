"""``serve.closed.device_idle``: Share of the traced slice with no work on the device."""

from portbench.readers import device_idle as read  # noqa: F401
