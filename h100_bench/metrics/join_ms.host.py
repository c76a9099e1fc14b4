"""join_ms.host: median host ms waiting on the card for a stack's result, its
``pipeline.join`` span (program_spans.join_ms)."""

from h100_bench.program_spans import join_ms as read  # noqa: F401
