"""What several metric readers share: each metric's file under
``metrics/`` binds one of these to its name (``read = ...``)."""

from __future__ import annotations

from h100_bench import roofline

__all__ = ["mpix_per_s", "tail_device_ms", "launches_per_call", "idle_share"]


def mpix_per_s(rec):
    """Input pixels of every call completed in the window, in millions,
    over the window's seconds (the first call's start to the last result's
    arrival in host memory)."""
    if not rec["pixels"] or rec["elapsed_s"] <= 0:
        return None
    return rec["pixels"] / rec["elapsed_s"] / 1e6


def tail_device_ms(rec):
    """Device ms a call in kernels that are not the program's five CUDA
    kernels, copies or fills: the Haralick tail plus the range reduction
    (and the zeroing of the counts), from the traced slice."""
    tr = rec["trace"]
    if not tr or not tr["calls"]:
        return None
    s = sum(v["s"] for k, v in tr["ops"].items()
            if roofline.program_kernel(k) is None and not k.startswith(("Memcpy", "Memset")))
    return s / tr["calls"] * 1e3 if s > 0 else None


def launches_per_call(rec):
    """Device operations (kernels, copies, fills) a call, from the traced
    slice."""
    tr = rec["trace"]
    if not tr or not tr["calls"]:
        return None
    n = sum(v["n"] for v in tr["ops"].values())
    return n / tr["calls"] if n else None


def idle_share(rec):
    """The share of the traced window with no kernel, copy or fill on the
    card, in %."""
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
