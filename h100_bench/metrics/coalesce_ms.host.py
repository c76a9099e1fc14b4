"""coalesce_ms.host: median host ms of stacking a stack of images, its
``pipeline.coalesce`` span (program_spans.coalesce_ms)."""

from h100_bench.program_spans import coalesce_ms as read  # noqa: F401
