"""Observability: tracing spans, a metrics registry and a flight recorder,
threaded through compile_plan and GLCMEngine.

Counterpart of ``repro.obs``. Its four modules import only the standard
library (nothing here imports the rest of the package, so every layer can
import ``repro_torch.obs`` without cycles):

* :mod:`repro_torch.obs.trace` — a thread-safe :class:`Tracer` of nested
  spans with an injectable monotonic clock, a bounded ring buffer, and Chrome
  ``trace_event`` JSON export (loadable in Perfetto / ``chrome://tracing``).
  Disabled by default with a no-op fast path; enable with ``REPRO_TRACE=1``
  or by injecting a live tracer.
* :mod:`repro_torch.obs.metrics` — labeled counters / gauges / histograms
  with Prometheus text exposition and a JSON snapshot.
* :mod:`repro_torch.obs.recorder` — a bounded ring of recent dispatch
  records, dumped on :class:`~repro_torch.serve.engine.QueueFullError` or
  dispatch exceptions for post-mortem (and to ``REPRO_FLIGHT_DIR`` when set).

The registry and the global tracer are the port's own objects, apart from
the reference's, with the same series and span names and the same
switches.

``python -m repro_torch.obs.report trace.json`` summarizes a captured trace
(per-phase breakdown, top spans, dispatch timeline, per-request span
trees) and converts/validates Chrome-trace JSON.
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Span, Tracer, get_tracer, set_tracer

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "get_registry",
    "get_tracer",
    "set_tracer",
]
