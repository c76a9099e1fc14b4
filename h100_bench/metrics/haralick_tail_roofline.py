"""haralick_tail_roofline: f1-f13 of the Haralick features
(``haralick_tail_kernel``, one warp a matrix up to L = 32;
``haralick_tail_wide_kernel``, one block a matrix past it) as a share of
its bound: the least time its bytes need, times its launches, over its
device time in the traced slice, in %.

A launch takes a call's n = batch x windows x pairs int32 count matrices
(L x L) and writes 13 float64 features a matrix and, where f14 is among the
features, the float64 P (L x L) and its marginals px and py (L each) that
f14's eigensolver reads. The bound is the bytes alone over the memory rate:
its float64 work, at most two logs an entry, is counted as hidden under
them. None where the slice holds no such kernel (the PyTorch tail)."""

from h100_bench import roofline

KERNELS = ("haralick_tail_kernel", "haralick_tail_wide_kernel")


def work(n: int, levels: int, with_p: bool) -> float:
    """Bytes of one launch on n matrices of L = levels: the counts in, the
    features out and, with f14, P, px and py out."""
    nbytes = n * levels * levels * 4 + n * 13 * 8
    if with_p:
        nbytes += n * (levels * levels + 2 * levels) * 8
    return float(nbytes)


def matrices(cfg: dict, batch: int) -> int:
    """The count matrices of one call: images x regions x pairs."""
    n = batch * len(cfg["pairs"])
    if cfg["region"] != "global":
        size, shape = cfg["image_size"], cfg["region_shape"]
        stride = cfg.get("region_stride") or shape
        n *= ((size - shape) // stride + 1) ** 2
    return n


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    mine = [v for k, v in tr["ops"].items() if roofline.short_name(k) in KERNELS]
    n, s = sum(v["n"] for v in mine), sum(v["s"] for v in mine)
    if not n or s <= 0:
        return None
    cfg = rec["config"]
    nbytes = work(matrices(cfg, rec["traffic"]["batch"]), cfg["levels"], cfg["features"] == 14)
    return 100.0 * n * nbytes / roofline.HBM_BYTES_PER_S / s
