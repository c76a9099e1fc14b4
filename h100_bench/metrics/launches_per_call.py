"""launches_per_call: device operations a call on whole images (readers.launches_per_call)."""

from h100_bench.readers import launches_per_call as read  # noqa: F401
