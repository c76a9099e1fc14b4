"""stage_ms.host: median host ms of staging a stack into pinned memory, its
``pipeline.stage`` span (program_spans.stage_ms)."""

from h100_bench.program_spans import stage_ms as read  # noqa: F401
