"""tail_device_ms.L256: the feature tail's device ms a call at L = 256, f14's
eigensolver included (readers.tail_device_ms)."""

from h100_bench.readers import tail_device_ms as read  # noqa: F401
