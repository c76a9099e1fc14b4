"""queue_wait_ms.serve: the 95th percentile of a request's wait in the engine's
queue, its ``glcm.queue_wait`` span (program_spans.queue_wait_ms)."""

from h100_bench.program_spans import queue_wait_ms as read  # noqa: F401
