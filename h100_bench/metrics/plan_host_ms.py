"""plan_host_ms: median host ms a call in ``plan.run`` outside its ``plan.tail``
(program_spans.plan_host_ms)."""

from h100_bench.program_spans import plan_host_ms as read  # noqa: F401
