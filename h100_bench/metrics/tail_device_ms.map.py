"""tail_device_ms.map: the feature tail's device ms a texture map (readers.tail_device_ms)."""

from h100_bench.readers import tail_device_ms as read  # noqa: F401
