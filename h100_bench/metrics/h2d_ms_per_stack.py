"""h2d_ms_per_stack: device ms of host-to-device copies a stack of
``batch`` images, from the traced slice (the whole window)."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["calls"]:
        return None
    s = sum(v["s"] for k, v in tr["ops"].items() if k.startswith("Memcpy HtoD"))
    if s <= 0:
        return None
    return s / (tr["calls"] / rec["traffic"]["batch"]) * 1e3
