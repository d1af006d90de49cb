"""``serve.closed.mfu``: Generator FLOPs of the notes answered in the traced slice, as a share of the bf16 peak."""

from portbench.readers import serve_mfu as read  # noqa: F401
