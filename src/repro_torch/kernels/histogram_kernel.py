"""The level-histogram kernel for Hopper, beside its plain PyTorch version.

Counterpart of the TPU kernel ``repro/kernels/histogram_kernel.py``:

``histogram`` ← ``histogram_pallas``
    values of any shape, cast to int32 (floats truncate toward zero) →
    (L,) int32 exact counts of each level; -1 and every other value outside
    [0, L) is not counted
    (CUDA source: ``csrc/histogram.cu``; plain version: ``histogram_plain``)

The paper's §II.A closes by noting that its vote-conflict analysis "serves
as a reference to the analysis of the image statistical histogram"; this is
that analogy on the card, with the vote kernel's machinery: R privatized
sub-histograms in shared memory, merged with atomics.

As in ``glcm_kernel``, the wrapper checks its arguments and dispatches on
the device of the tensor it was given through ``build.dispatch``: on the CPU
it computes the plain version (in the analyzer's ``kernel:histogram``
scope); on a CUDA tensor it launches the kernel, or raises — it never falls
back. ``build.launch`` raises ``histogram.launches`` by one at each launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["histogram", "histogram_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def histogram_plain(values: torch.Tensor, levels: int) -> torch.Tensor:
    """Plain version of ``histogram``: a ``bincount`` with ``minlength=L``
    of the int32-cast values that lie in [0, L), as int32."""
    v = values.reshape(-1).to(torch.int32).to(torch.int64)
    v = v[(v >= 0) & (v < levels)]
    return torch.bincount(v, minlength=levels).to(torch.int32)


def histogram(
    values: torch.Tensor,
    *,
    levels: int,
    chunk: int = 2048,
    copies: int = 4,
) -> torch.Tensor:
    """Exact int32 counts of each level in ``values`` (any shape), in one
    launch. Values are cast to int32 as the reference casts them; -1
    entries are padding, and no value outside [0, L) is counted. ``chunk``
    is the slice a block counts per step and ``copies`` the paper's R, the
    private sub-histograms per block; neither changes the counts."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if copies < 1 or chunk < 1:
        raise ValueError(f"chunk and copies must be >= 1, got {chunk}, {copies}")
    if chunk % copies:
        raise ValueError(f"chunk ({chunk}) must be divisible by copies ({copies})")
    return build.dispatch(histogram, values, lambda: histogram_plain(values, levels),
                          lambda: _launch_histogram(values, levels, chunk, copies))


histogram.launches = 0


def _launch_histogram(values, levels, chunk, copies) -> torch.Tensor:
    v = values.reshape(-1).to(torch.int32).contiguous()
    out = torch.zeros((levels,), dtype=torch.int32, device=v.device)
    if v.numel() == 0:  # a zero-block grid is an invalid launch
        return out
    build.launch(histogram, "histogram_launch", [_P, _P, _LL, _I, _I, _I, _P], v.device,
                 v.data_ptr(), out.data_ptr(), v.numel(), levels, copies, chunk)
    return out
