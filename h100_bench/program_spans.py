"""What the readers of the program's own spans share (``source:
"program_span"``): each metric's file under ``metrics/`` binds one of these
to its name (``read = ...``).

The spans come from the ``Tracer`` a traced run installs as the program's
global one (``repro_torch.obs.trace.get_tracer()``). A reader takes those of
the measured window: from the first ``bench.*`` span's start to the last
one's end, so that set-up and warm-up are left out. That is the whole
window, not only its profiled slice. Each reader returns None where the
program records none of its spans: a program without them, or the CPU,
where the host stream stages and joins nothing.
"""

from __future__ import annotations

from h100_bench import stats
from repro_torch.obs.trace import get_tracer

__all__ = ["window_spans", "tail_host_ms", "plan_host_ms", "coalesce_ms", "stage_ms",
           "join_ms", "queue_wait_ms"]


def window_spans() -> list:
    """The program tracer's spans inside the window of ``bench.*`` spans."""
    spans = get_tracer().spans()
    bench = [s for s in spans if s.name.startswith("bench.")]
    if not bench:
        return []
    t0, t1 = min(s.t0 for s in bench), max(s.t1 for s in bench)
    return [s for s in spans if t0 <= s.t0 and s.t1 <= t1]


def _ms(name: str, q: float = 50) -> float | None:
    """The q-th percentile of the window's ``name`` spans, in ms."""
    durs = [s.dur * 1e3 for s in window_spans() if s.name == name]
    return stats.percentile(durs, q) if durs else None


def _own_ms(name: str, child: str) -> float | None:
    """Median host ms of the window's ``name`` spans, each less its own
    ``child`` spans (those whose parent it is)."""
    spans = window_spans()
    inner: dict[int, float] = {}
    for s in spans:
        if s.name == child and s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0.0) + s.dur
    own = [(s.dur - inner.get(s.id, 0.0)) * 1e3 for s in spans if s.name == name]
    return stats.percentile(own, 50) if own else None


def tail_host_ms(rec):
    """Median host ms of a call's ``plan.tail`` less its own
    ``haralick.eigvalsh`` child: the host enqueueing symmetric, normalize
    and the Haralick features. f14's eigensolver reads its error code back,
    so on the card its span holds the wait for all the work queued before
    it; that wait is left out."""
    return _own_ms("plan.tail", "haralick.eigvalsh")


def plan_host_ms(rec):
    """Median host ms of a call's ``plan.run`` less its own ``plan.tail``
    child: the input check, the range reduction, the count's launch and the
    plan's own code."""
    return _own_ms("plan.run", "plan.tail")


def coalesce_ms(rec):
    """Median host ms of ``pipeline.coalesce``: the ``np.stack`` of a stack."""
    return _ms("pipeline.coalesce")


def stage_ms(rec):
    """Median host ms of ``pipeline.stage``: a stack's copy into pinned
    memory, the wait for its slot's previous copy included."""
    return _ms("pipeline.stage")


def join_ms(rec):
    """Median host ms of ``pipeline.join``: the host waiting on the card for
    a stack's result."""
    return _ms("pipeline.join")


def queue_wait_ms(rec):
    """The 95th percentile of the engine's ``glcm.queue_wait`` spans: a
    request's wait from ``submit()`` until its batch is padded."""
    return _ms("glcm.queue_wait", 95)
