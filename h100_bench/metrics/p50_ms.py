"""p50_ms: the median of the same samples as p95_ms."""

from h100_bench import stats


def read(rec):
    lat = rec.get("latencies_ms")
    return stats.percentile(lat, 50) if lat else None
