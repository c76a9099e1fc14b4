"""tail_device_ms: the feature tail's device ms a call on whole images (readers.tail_device_ms)."""

from h100_bench.readers import tail_device_ms as read  # noqa: F401
