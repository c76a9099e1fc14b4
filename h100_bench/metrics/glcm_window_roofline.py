"""glcm_window_roofline: glcm_window's bound (``roofline.window_work`` of
one image's texture map, over the data sheet's peaks) times its launches,
over its device time in the traced slice, in %."""

from h100_bench import reference, roofline

_ITEMSIZE = {"uint8": 1, "float32": 4}


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    mine = [v for k, v in tr["ops"].items() if roofline.program_kernel(k) == "glcm_window"]
    n, s = sum(v["n"] for v in mine), sum(v["s"] for v in mine)
    if not n or s <= 0:
        return None
    cfg = rec["config"]
    size = cfg["image_size"]
    work = roofline.window_work(size, size, _ITEMSIZE[cfg["dtype"]], cfg["levels"],
                                reference.glcm.offsets(cfg["pairs"]), cfg["region_shape"],
                                cfg["region_stride"])
    return 100.0 * n * roofline.bound_s(*work) / s
