"""launches_per_call.map: device operations a texture map (readers.launches_per_call)."""

from h100_bench.readers import launches_per_call as read  # noqa: F401
