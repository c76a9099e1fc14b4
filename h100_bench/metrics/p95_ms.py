"""p95_ms: the 95th percentile of every request due in the window, each
timed from when it was due to when its features were in host memory."""

from h100_bench import stats


def read(rec):
    lat = rec.get("latencies_ms")
    return stats.percentile(lat, 95) if lat else None
