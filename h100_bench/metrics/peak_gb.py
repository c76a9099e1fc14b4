"""peak_gb: the most device memory the program held at once during the
window (``max_memory_allocated``), less what was allocated at the window's
start (the benchmark's own resident inputs), in GB."""


def read(rec):
    if not rec["peak_bytes"]:
        return None
    return (rec["peak_bytes"] - rec["base_bytes"]) / 1e9
