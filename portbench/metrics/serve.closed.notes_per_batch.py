"""``serve.closed.notes_per_batch``: Notes a device batch of the service, from /healthz."""

from portbench.readers import notes_per_batch as read  # noqa: F401
