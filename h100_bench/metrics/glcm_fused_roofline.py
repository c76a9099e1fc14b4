"""glcm_fused_roofline: glcm_fused's bound (``roofline.fused_work`` of a
full stack, over the data sheet's peaks) times its launches, over its
device time in the traced slice, in %."""

from h100_bench import reference, roofline

_ITEMSIZE = {"uint8": 1, "float32": 4}


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    mine = [v for k, v in tr["ops"].items() if roofline.program_kernel(k) == "glcm_fused"]
    n, s = sum(v["n"] for v in mine), sum(v["s"] for v in mine)
    if not n or s <= 0:
        return None
    cfg = rec["config"]
    size = cfg["image_size"]
    work = roofline.fused_work(rec["traffic"]["batch"], size, size, _ITEMSIZE[cfg["dtype"]],
                               cfg["levels"], reference.glcm.offsets(cfg["pairs"]))
    return 100.0 * n * roofline.bound_s(*work) / s
