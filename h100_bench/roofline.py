"""The yardstick for kernels: the device's peaks, which profiler names are
which kernel of the program, and the bytes and operations each kernel's
work needs.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the scalar rate: every input byte read once and every
output byte written once; one binning of each pixel (5 operations:
subtract, divide, multiply, floor, clip) and one add per vote. The votes
are integer atomics, held against the float32 rate outside the tensor
cores: the data sheet gives no int32 rate, so that is a convention.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "SCALAR_OPS_PER_S", "KERNELS", "short_name",
           "program_kernel", "bound_s", "fused_work", "window_work"]

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# Device kernel name (as the profiler gives it, shortened) -> the program's
# kernel. ``march_kernel`` serves both glcm_fused and glcm_volume; no cell
# here runs a volume.
KERNELS = {
    "march_kernel": "glcm_fused",
    "staged_kernel": "glcm_window",
    "direct_kernel": "glcm_window",
    "vote_kernel": "glcm_vote",
    "histogram_kernel": "histogram",
}


def short_name(name: str) -> str:
    """A device operation's name without return type, namespaces, template
    arguments or parameters; copies and fills keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in "<(":
        cut = s.find(stop)
        if cut > 0:
            s = s[:cut]
    return s.rsplit("::", 1)[-1].strip()


def program_kernel(name: str) -> str | None:
    """The program's kernel a device operation belongs to, or None."""
    return KERNELS.get(short_name(name))


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the work can take on the device."""
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def _votes(h: int, w: int, offs) -> int:
    return sum(max(h - abs(dy), 0) * max(w - abs(dx), 0) for dy, dx in offs)


def fused_work(batch: int, h: int, w: int, itemsize: int, levels: int, offs
               ) -> tuple[float, float]:
    """(bytes, operations) of one glcm_fused launch on a (batch, h, w)
    stack: the stack and a (lo, span) pair per image in, the (batch, n_off,
    L, L) int32 counts out."""
    n_off = len(offs)
    nbytes = batch * h * w * itemsize + batch * 2 * 4 + batch * n_off * levels**2 * 4
    ops = 5 * batch * h * w + batch * _votes(h, w, offs)
    return float(nbytes), float(ops)


def window_work(h: int, w: int, itemsize: int, levels: int, offs, size: int,
                stride: int) -> tuple[float, float]:
    """(bytes, operations) of one glcm_window launch on one (h, w) image:
    the image and its (lo, span) in, the (gh, gw, n_off, L, L) int32 counts
    out; every pixel binned once, one add per vote of every window."""
    gh, gw = (h - size) // stride + 1, (w - size) // stride + 1
    n_win, n_off = gh * gw, len(offs)
    nbytes = h * w * itemsize + 2 * 4 + n_win * n_off * levels**2 * 4
    ops = 5 * h * w + n_win * _votes(size, size, offs)
    return float(nbytes), float(ops)
