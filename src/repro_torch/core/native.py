"""Host-native NumPy GLCM counting — the single-core CPU path.

Counterpart of ``repro.core.native``, whose NumPy functions this module
copies (``uniform_params_np``, ``quantize_stack``, ``counts_pairs``,
``native_counts``). ``np.bincount`` over the linearised pair positions
(``pos = ref·L + assoc``) is the honest serial-CPU way to count; the
registry exposes it as the ``native`` backend, which ``scheme="native"``
picks, and "auto" only where the autotuner measured it the winner.

The counting runs outside PyTorch: ``compile_plan`` sees
``caps.host_native`` and calls :func:`native_counts` on the input as a
NumPy array; the symmetric/normalize/features tail then runs on the plan's
device. Quantization is fused here too — :func:`quantize_stack` replicates
``core.quantize``'s binning expression in float32 NumPy ops (bit-exact: the
affine is the same IEEE single-precision op sequence).

Everything is int64 internally: bincount requires intp indices anyway, and
pre-widening once beats casting per offset.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.spec import GLCMSpec

__all__ = ["counts_pairs", "native_counts", "quantize_stack", "uniform_params_np"]

_TINY = float(np.finfo(np.float32).tiny)


def uniform_params_np(
    stack: np.ndarray,
    vmin: float | None = None,
    vmax: float | None = None,
) -> tuple:
    """NumPy twin of ``core.quantize.uniform_params`` for a (B, ...) stack:
    static floats when the range is pinned, else per-image (B,) reductions
    (min/max are order-independent, so this matches the torch path exactly)."""
    if vmin is not None and vmax is not None:
        return float(vmin), max(float(vmax) - float(vmin), _TINY)
    x = stack.astype(np.float32)
    axes = tuple(range(1, x.ndim))
    b = x.shape[0]
    lo = x.min(axis=axes) if vmin is None else np.full((b,), vmin, np.float32)
    hi = x.max(axis=axes) if vmax is None else np.full((b,), vmax, np.float32)
    span = np.maximum(hi - lo, _TINY)
    return lo, span


def quantize_stack(stack: np.ndarray, spec: GLCMSpec, quant) -> np.ndarray:
    """(B, *spatial) values → int64 levels in [0, L).

    ``quant`` is None (input already holds level indices — plain cast) or
    (lo, span) with scalars / per-image (B,) arrays, applying the same
    float32 affine as ``core.quantize.bin_values``.
    """
    if quant is None:
        return stack.astype(np.int64)
    lo = np.asarray(quant[0], np.float32)
    span = np.asarray(quant[1], np.float32)
    if lo.ndim:
        shape = (stack.shape[0],) + (1,) * (stack.ndim - 1)
        lo = lo.reshape(shape)
        span = span.reshape(shape)
    q = np.floor((stack.astype(np.float32) - lo) / span * spec.levels)
    return np.clip(q, 0, spec.levels - 1).astype(np.int64)


def _plane_slices(dims, offset):
    """Python twin of ``kernels.ref.pair_planes_nd``'s slicing: the (assoc,
    ref) index tuples for ``offset`` over spatial extents ``dims``."""
    assoc: list = [slice(None)]
    ref: list = [slice(None)]
    for delta, size in zip(offset, dims):
        if abs(delta) >= size:
            raise ValueError(f"offset {offset} exceeds spatial extents {dims}")
        if delta >= 0:
            assoc.append(slice(0, size - delta))
            ref.append(slice(delta, size))
        else:
            assoc.append(slice(-delta, size))
            ref.append(slice(0, size + delta))
    return tuple(assoc), tuple(ref)


def counts_pairs(
    qstack: np.ndarray, levels: int, offsets: tuple
) -> np.ndarray:
    """Pair voting for a quantized (B, *spatial) int stack → (B, n_off, L, L)
    int64 counts, one ``np.bincount`` per offset over the batch-linearized
    positions (``pos = b·L² + ref·L + assoc``)."""
    b = qstack.shape[0]
    cells = levels * levels
    base = (np.arange(b, dtype=np.int64) * cells).reshape(
        (b,) + (1,) * (qstack.ndim - 1)
    )
    # ref-side contribution precomputed once: one mul+add over the stack is
    # shared by every offset's (strided-view) plane sum.
    xl = qstack * levels + base
    out = np.empty((len(offsets), b, cells), np.int64)
    dims = qstack.shape[1:]
    for k, off in enumerate(offsets):
        a_ix, r_ix = _plane_slices(dims, off)
        pos = xl[r_ix] + qstack[a_ix]
        out[k] = np.bincount(pos.ravel(), minlength=b * cells).reshape(b, cells)
    return out.transpose(1, 0, 2).reshape(b, len(offsets), levels, levels)


def native_counts(stack: np.ndarray, spec: GLCMSpec, quant) -> np.ndarray:
    """The ``native`` backend's host entry: raw-or-quantized (B, *spatial)
    ndarray → (B, *grid, n_pairs, L, L) int64 counts, regions included.

    ``quant`` as in :func:`quantize_stack`; per-image ranges apply to every
    window of that image (regions share their image's quantization).
    """
    stack = np.asarray(stack)
    q = quantize_stack(stack, spec, quant)
    offsets = spec.offsets()
    if spec.region == "global":
        return counts_pairs(q, spec.levels, offsets)
    nd = spec.ndim
    rshape = tuple(spec.region_shape)
    strides = tuple(spec.strides)
    windows = np.lib.stride_tricks.sliding_window_view(
        q, rshape, axis=tuple(range(1, nd + 1))
    )
    sub = windows[(slice(None),) + tuple(slice(None, None, st) for st in strides)]
    grid = sub.shape[1 : 1 + nd]
    flat = np.ascontiguousarray(sub.reshape((-1,) + rshape))
    counts = counts_pairs(flat, spec.levels, offsets)
    return counts.reshape(stack.shape[:1] + grid + counts.shape[1:])
