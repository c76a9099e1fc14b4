"""tail_host_ms: median host ms of the feature tail a call, its ``plan.tail``
span less f14's ``haralick.eigvalsh`` inside it, where the host waits on the
card (program_spans.tail_host_ms), beside the device's ``tail_device_ms``."""

from h100_bench.program_spans import tail_host_ms as read  # noqa: F401
