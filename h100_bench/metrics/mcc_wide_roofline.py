"""mcc_wide_roofline: f14's eigensolver for 32 < L <= 1024
(``mcc_wide_kernel``, one block a matrix) as a share of its bound: the
least time its work needs, times its launches, over its device time in the
traced slice, in %.

A launch takes the batch's n = batch x pairs Gram matrices G (L x L
float64, made by the caller) and writes n eigenvalues: n L^2 doubles in
and n out. Its float64 work is the reduction to tridiagonal form, 4/3 L^3
a matrix (LAPACK dsytrd's count), and the Sturm counts of a bisection to
53 bits for one eigenvalue, 3 L a step; the float64 rate outside the
tensor cores is the data sheet's 33.5 TFLOP/s. None where the slice holds
no such kernel (f14 on another solver)."""

from h100_bench import roofline

KERNEL = "mcc_wide_kernel"
FP64_OPS_PER_S = 33.5e12  # NVIDIA H100 SXM data sheet, at its 700 W limit


def work(n: int, levels: int) -> tuple[float, float]:
    """(bytes, float64 operations) of one launch on n matrices of L = levels."""
    nbytes = n * (levels * levels + 1) * 8
    ops = n * (4 * levels**3 / 3 + 3 * levels * 53)
    return float(nbytes), float(ops)


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    mine = [v for k, v in tr["ops"].items() if roofline.short_name(k) == KERNEL]
    n, s = sum(v["n"] for v in mine), sum(v["s"] for v in mine)
    if not n or s <= 0:
        return None
    cfg = rec["config"]
    nbytes, ops = work(rec["traffic"]["batch"] * len(cfg["pairs"]), cfg["levels"])
    bound = max(nbytes / roofline.HBM_BYTES_PER_S, ops / FP64_OPS_PER_S)
    return 100.0 * n * bound / s
