"""f14_host_ms.L256: median host ms a call of f14's ``haralick.eigvalsh``
span, whichever ``solver`` it took: on f14's kernel the launch (and G's
GEMM); on the chunked eigvalsh (``chunks`` calls, each reading an error
code back) also the host's wait for the work queued before it. None where
no such span was recorded (a program without it)."""

from h100_bench import stats
from h100_bench.program_spans import window_spans


def read(rec):
    durs = [s.dur * 1e3 for s in window_spans() if s.name == "haralick.eigvalsh"]
    return stats.percentile(durs, 50) if durs else None
