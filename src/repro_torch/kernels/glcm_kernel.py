"""The GLCM voting kernels for Hopper, each beside its plain PyTorch version.

Counterparts of the TPU kernels of ``repro/kernels/glcm_kernel.py``:

``glcm_vote``   ← ``repro/kernels/glcm_kernel.py::glcm_vote_pallas``
    (B, N) int32 pair streams → (B, L, L) int32 counts
    (CUDA source: ``csrc/glcm_vote.cu``; plain version: ``glcm_vote_plain``)
``glcm_fused``  ← ``repro/kernels/glcm_kernel.py::glcm_fused_pallas``
    (B, H, W) stack, int32 levels or raw f32 / uint8 + per-image (lo, span)
    → (B, n_off, L, L) int32 counts in one pass over the image
    (CUDA source: ``csrc/glcm_fused.cu``; plain version: ``glcm_fused_plain``)
``glcm_window`` ← ``glcm_window_pallas``
    windows of a (B, H, W) image (read in place) or an extracted
    (B, gh, gw, rh, rw) patch grid, int32 levels or raw f32 / uint8 +
    per-image (lo, span) → (B, gh, gw, n_off, L, L) int32, one GLCM per
    window, pairs never crossing a window
    (CUDA source: ``csrc/glcm_window.cu``; plain version: ``glcm_window_plain``)
``glcm_volume`` ← ``glcm_volume_pallas``
    (B, D, H, W) volumes, int32 levels or raw f32 / uint8 + per-volume
    (lo, span) → (B, n_off, L, L) int32 over (dz, dy, dx) offsets in one pass
    (CUDA source: ``csrc/glcm_volume.cu``; plain version: ``glcm_volume_plain``)

Each wrapper checks its arguments, then dispatches on the device of the
tensor it was given through ``build.dispatch``: on the CPU it computes the
plain version, inside the analyzer's ``kernel:<name>`` scope
(``analysis.scopes``, the counterpart of the ``pallas_call`` boundary); on a
CUDA tensor it launches the kernel through ``build.launch``, or raises — it
never falls back. Each keeps a launch count, a plain int attribute
(``glcm_vote.launches``), which ``build.launch`` raises by one at each
kernel launch.

The kernels are built with nvcc at first use (``kernels.build``) and bound
with ctypes; the sources say how each is designed and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import assert_levels, repeat_params
from repro_torch.core.schemes import glcm_scatter_batch
from repro_torch.kernels import build

__all__ = [
    "glcm_vote",
    "glcm_vote_plain",
    "glcm_fused",
    "glcm_fused_plain",
    "glcm_window",
    "glcm_window_plain",
    "glcm_volume",
    "glcm_volume_plain",
    "DEFAULT_CHUNK",
    "DEFAULT_COPIES",
    "DEFAULT_SLAB_D",
    "MAX_OFFSETS",
    "kernel_kind",
    "launch_plan",
]

DEFAULT_CHUNK = 2048   # pair-stream slice a block votes per step
DEFAULT_COPIES = 4     # R, the paper's copy count
DEFAULT_SLAB_D = 8     # depth slices per slab of the volume kernel
MAX_OFFSETS = 64       # offsets per launch (kMaxOffsets in the image kernels)
MAX_STREAMS = 65535    # streams per vote launch (the grid's y extent)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


# ---------------------------------------------------------------------------
# Kernel 1: pair-stream voting
# ---------------------------------------------------------------------------


def glcm_vote_plain(assoc: torch.Tensor, ref: torch.Tensor, levels: int) -> torch.Tensor:
    """Plain version of ``glcm_vote``: (B, N) streams → (B, L, L) int32 by a
    ``bincount`` over ``b·L² + ref·L + assoc`` of the pairs whose two levels
    lie in [0, L)."""
    b = assoc.shape[0]
    a = assoc.to(torch.int64)
    r = ref.to(torch.int64)
    valid = (a >= 0) & (a < levels) & (r >= 0) & (r < levels)
    base = torch.arange(b, device=a.device)[:, None] * (levels * levels)
    pos = (base + r * levels + a)[valid]
    counts = torch.bincount(pos, minlength=b * levels * levels)
    return counts.reshape(b, levels, levels).to(torch.int32)


def glcm_vote(
    assoc: torch.Tensor,
    ref: torch.Tensor,
    *,
    levels: int,
    chunk: int = DEFAULT_CHUNK,
    copies: int = DEFAULT_COPIES,
) -> torch.Tensor:
    """Vote (assoc, ref) pair streams into GLCMs (int32).

    Streams are equal-shape integer tensors, (N,) → (L, L) or (B, N) →
    (B, L, L) in one launch. A value outside [0, L) (-1 is the pad) does not
    vote. ``chunk`` is the slice a block votes per step and ``copies`` the
    paper's R, the private sub-histograms per block; neither changes the
    counts. Values are cast to int32, as the reference kernel casts them.
    """
    if assoc.shape != ref.shape or assoc.ndim not in (1, 2):
        raise ValueError(
            f"pair streams must be equal 1-D or 2-D, got {tuple(assoc.shape)} vs "
            f"{tuple(ref.shape)}"
        )
    if assoc.device != ref.device:
        raise ValueError(f"pair streams on different devices: {assoc.device} vs {ref.device}")
    assert_levels(levels)
    if copies < 1 or chunk < 1:
        raise ValueError(f"chunk and copies must be >= 1, got {chunk}, {copies}")
    if chunk % copies:
        raise ValueError(f"chunk ({chunk}) must be divisible by copies ({copies})")
    batched = assoc.ndim == 2
    a = assoc if batched else assoc[None]
    r = ref if batched else ref[None]
    out = build.dispatch(glcm_vote, a, lambda: glcm_vote_plain(a, r, levels),
                         lambda: _launch_vote(a, r, levels, chunk, copies))
    return out if batched else out[0]


glcm_vote.launches = 0


def _launch_vote(a, r, levels, chunk, copies) -> torch.Tensor:
    """Launch the vote kernel, once per group of at most MAX_STREAMS streams
    (a region fallback can hand it more streams than one grid holds)."""
    a = a.to(torch.int32).contiguous()
    r = r.to(torch.int32).contiguous()
    b, n = a.shape
    out = torch.zeros((b, levels, levels), dtype=torch.int32, device=a.device)
    for lo in range(0, b, MAX_STREAMS):
        hi = min(lo + MAX_STREAMS, b)
        build.launch(glcm_vote, "glcm_vote_launch", [_P, _P, _P, _I, _LL, _I, _I, _I, _P],
                     a.device, a[lo:hi].data_ptr(), r[lo:hi].data_ptr(), out[lo:hi].data_ptr(),
                     hi - lo, n, levels, copies, chunk)
    return out


# ---------------------------------------------------------------------------
# Kernel 2: fused multi-offset image pass
# ---------------------------------------------------------------------------


def glcm_fused_plain(
    stack: torch.Tensor,
    levels: int,
    offsets: tuple[tuple[int, int], ...],
    *,
    quant=None,
) -> torch.Tensor:
    """Plain version of ``glcm_fused``: (B, H, W) → (B, n_off, L, L) int32,
    a masked ``bincount`` over the pair planes of every offset, binned from
    raw values (float32, uint8 or any real dtype) when ``quant`` is given
    (the "scatter" scheme)."""
    return _pairless_zero(glcm_scatter_batch, stack, levels, tuple(offsets), quant)


def _pairless_zero(count, stack, levels: int, offsets, quant) -> torch.Tensor:
    """``count(stack, levels, offsets, quant=quant)``, with zero counts for
    an offset that leaves no pair in the input (dy >= H or dz >= D, which
    the kernels, like the reference's, accept up to tile_h or slab_d)."""
    dims = stack.shape[1:]
    fits = [all(abs(o) < n for o, n in zip(off, dims)) for off in offsets]
    if all(fits):
        return count(stack, levels, offsets, quant=quant)
    out = torch.zeros((stack.shape[0], len(offsets), levels, levels), dtype=torch.int32,
                      device=stack.device)
    kept = tuple(off for off, f in zip(offsets, fits) if f)
    if kept:
        out[:, torch.tensor(fits, device=stack.device)] = count(stack, levels, kept, quant=quant)
    return out


def glcm_fused(
    img: torch.Tensor,
    *,
    levels: int,
    offsets: tuple[tuple[int, int], ...],
    tile_h: int = 8,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """One pass over image(s) → multi-offset GLCMs (int32).

    ``img`` is (H, W) → (n_off, L, L) or (B, H, W) → (B, n_off, L, L), in
    one launch. ``offsets`` are (dy, dx) with 0 <= dy <= tile_h and
    |dx| < W, as the reference kernel requires. Without ``quant`` the values
    are levels (cast to int32; one outside [0, L) does not vote). With
    ``quant=(lo, span)`` — python floats or per-image (B,) tensors — the
    values are raw and each is binned once in the kernel by the affine of
    ``core.quantize.bin_values``; the quantized image is never written, and
    uint8 is read as it is (other dtypes as float32).
    ``tile_h`` is the fewest rows a block marches and ``copies`` the
    paper's R; neither changes the counts.
    """
    if img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W) image, got {tuple(img.shape)}")
    assert_levels(levels)
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if tile_h < 1 or copies < 1:
        raise ValueError(f"tile_h and copies must be >= 1, got {tile_h}, {copies}")
    h, w = img.shape[-2:]
    for dy, dx in offsets:
        if not (0 <= dy <= tile_h):
            raise ValueError(f"dy={dy} must be in [0, tile_h={tile_h}]")
        if abs(dx) >= w:
            raise ValueError(f"|dx|={abs(dx)} must be < width={w}")
    batched = img.ndim == 3
    stack = img if batched else img[None]
    out = build.dispatch(glcm_fused, stack,
                         lambda: glcm_fused_plain(stack, levels, offsets, quant=quant),
                         lambda: _launch_fused(stack, levels, offsets, tile_h, copies, quant))
    return out if batched else out[0]


glcm_fused.launches = 0


def _quant_block(quant, b: int, device) -> torch.Tensor:
    """(lo, span) — python floats or per-image (B,) tensors — as the (B, 2)
    f32 operand the kernel indexes by image."""
    lo = torch.as_tensor(quant[0], dtype=torch.float32, device=device).reshape(-1).expand(b)
    span = torch.as_tensor(quant[1], dtype=torch.float32, device=device).reshape(-1).expand(b)
    return torch.stack([lo, span], dim=1).contiguous()


# What the image kernels read (``kind`` in csrc/glcm_march.cuh): int32
# levels, or float32 or uint8 raw values binned in the kernel.
KIND_LEVELS, KIND_FLOAT, KIND_BYTE = 0, 1, 2


def _kernel_input(stack: torch.Tensor, quant) -> tuple[torch.Tensor, int]:
    """The input as the image kernels (fused, window, volume) read it, and
    its kind: levels as int32; raw uint8 as it is (no widened copy: the kernel
    converts each value to float32 exactly, as ``bin_values`` does); any
    other raw dtype as float32. A contiguous stack, a slice of one included,
    is not copied."""
    kind = kernel_kind(stack.dtype, quant)
    if kind == KIND_LEVELS:
        return stack.to(torch.int32).contiguous(), kind
    if kind == KIND_BYTE:
        return stack.contiguous(), kind
    return stack.to(torch.float32).contiguous(), kind


def kernel_kind(dtype: torch.dtype, quant) -> int:
    """What the image kernels read from an input of ``dtype`` (see
    ``_kernel_input``): levels without ``quant``, else raw uint8 as it is or
    any other dtype as float32."""
    if quant is None:
        return KIND_LEVELS
    return KIND_BYTE if dtype == torch.uint8 else KIND_FLOAT


def launch_plan(kernel: str, shape: tuple[int, ...], offsets, *, levels: int,
                split: int | None = None, region_shape=None, stride=None, copies: int = 1,
                kind: int = KIND_FLOAT) -> dict:
    """The launch an image kernel would make for a contiguous input of
    ``shape`` on the current card, without launching. ``glcm_fused``: shape
    (B, H, W), ``split`` = tile_h; ``glcm_volume``: shape (B, D, H, W),
    ``split`` = slab_d — blocks per SM, shared bytes, the ring's geometry,
    the grid, registers, and ``cluster``: the blocks of a cluster that hold
    half the offsets' counts in their shared memory (0 where the votes go
    to per-block sets, ``shared_hist`` 1, or to global atomics).
    ``glcm_window``: shape (B, H, W) with ``region_shape`` and ``stride``,
    or a (B, gh, gw, rh, rw) patch grid — the path (staged, or direct into
    shared sets or with global atomics), blocks per SM, shared bytes,
    copies, windows per run, grid, registers.
    Needs the card and builds the kernel."""
    n_off = len(offsets)
    cols = list(zip(*offsets))
    arrays = [(ctypes.c_int * n_off)(*c) for c in cols]
    info = (ctypes.c_int * 13)()
    if kernel == "glcm_window":
        windows, _ = _windows(torch.empty(shape, device="meta"), region_shape, stride)
        argtypes = [_I] * 6 + [_LL] * 4 + [_I, _I]
        args = (kind, *windows.shape, *windows.stride()[:4], levels, copies)
        keys = ("path", "blocks_per_sm", "smem_bytes", "copies", "windows_per_run", "grid",
                "registers", "local_bytes")
    else:
        argtypes = [_I] * (len(shape) + 4)
        args = (kind, *shape, levels, copies, split)
        keys = ("blocks_per_sm", "smem_bytes", "shared_hist", "copies", "runs", "tile_rows",
                "planes_per_step", "ring_slots", "grid", "planes_per_block", "registers",
                "local_bytes", "cluster")
    build.call(kernel, f"{kernel}_plan", argtypes + [_P] * len(cols) + [_I, _P],
               *args, *(ctypes.addressof(a) for a in arrays), n_off, ctypes.addressof(info))
    plan = dict(zip(keys, info))
    if kernel == "glcm_window":
        plan["path"] = ("staged", "direct_shared", "direct_global")[plan["path"]]
    return plan


def _launch_fused(stack, levels, offsets, tile_h, copies, quant) -> torch.Tensor:
    b, h, w = stack.shape
    if b > 65535:
        raise ValueError(f"glcm_fused takes at most 65535 images per launch, got {b}")
    x, kind = _kernel_input(stack, quant)
    q = None if quant is None else _quant_block(quant, b, stack.device)
    n_off = len(offsets)
    out = torch.zeros((b, n_off, levels, levels), dtype=torch.int32, device=stack.device)
    dy = (ctypes.c_int * n_off)(*(o[0] for o in offsets))
    dx = (ctypes.c_int * n_off)(*(o[1] for o in offsets))
    build.launch(glcm_fused, "glcm_fused_launch",
                 [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P], stack.device,
                 x.data_ptr(), kind, None if q is None else q.data_ptr(), out.data_ptr(),
                 b, h, w, levels, copies, tile_h, ctypes.addressof(dy), ctypes.addressof(dx),
                 n_off)
    return out


# ---------------------------------------------------------------------------
# Kernel 3: per-window voting (texture maps)
# ---------------------------------------------------------------------------


def _pair(v, what: str) -> tuple[int, int]:
    t = (int(v), int(v)) if isinstance(v, int) else tuple(int(x) for x in v)
    if len(t) != 2 or min(t) < 1:
        raise ValueError(f"{what} must be a positive int or (h, w) pair, got {v!r}")
    return t


def _windows(x: torch.Tensor, region_shape, stride) -> tuple[torch.Tensor, bool]:
    """The (B, gh, gw, rh, rw) window grid of ``x`` and whether ``x`` was
    batched. Without ``region_shape``, ``x`` is already a (gh, gw, rh, rw) or
    (B, gh, gw, rh, rw) patch grid. With it, ``x`` is an (H, W) or (B, H, W)
    image and the windows are strided views of it — window (i, j) starts at
    (i·sh, j·sw); nothing is copied. ``stride`` defaults to the region shape
    (tiles); window positions that do not fit are dropped."""
    if region_shape is None:
        if stride is not None:
            raise ValueError("stride needs region_shape (an image, not a patch grid)")
        if x.ndim not in (4, 5):
            raise ValueError(
                f"expected (gh, gw, rh, rw) or (B, gh, gw, rh, rw) patches, got "
                f"{tuple(x.shape)}"
            )
        return (x if x.ndim == 5 else x[None]), x.ndim == 5
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W) image, got {tuple(x.shape)}")
    rh, rw = _pair(region_shape, "region_shape")
    sh, sw = _pair(region_shape if stride is None else stride, "stride")
    img = x if x.ndim == 3 else x[None]
    h, w = img.shape[-2:]
    if rh > h or rw > w:
        raise ValueError(f"region {(rh, rw)} exceeds input shape {(h, w)}")
    return img.unfold(1, rh, sh).unfold(2, rw, sw), x.ndim == 3


def _counts_by_offset(stack, levels: int, offsets, *, quant) -> torch.Tensor:
    """(N, *spatial) → (N, n_off, L, L) int32: per offset, one masked
    ``bincount`` over ``n·L² + ref·L + assoc``, so that the index of one
    offset, not of all, is in memory at a time."""
    return torch.stack(
        [glcm_scatter_batch(stack, levels, (off,), quant=quant)[:, 0] for off in offsets],
        dim=1,
    )


def glcm_window_plain(
    x: torch.Tensor,
    levels: int,
    offsets: tuple[tuple[int, int], ...],
    *,
    region_shape=None,
    stride=None,
    quant=None,
) -> torch.Tensor:
    """Plain version of ``glcm_window``: the windows as a flat batch of
    patches, each image's (lo, span) repeated over its windows, counted by
    masked ``bincount`` over (window, ref, assoc) per offset."""
    windows, batched = _windows(x, region_shape, stride)
    b, gh, gw, rh, rw = windows.shape
    flat = windows.reshape(-1, rh, rw)
    if quant is not None:
        quant = repeat_params(quant, flat.shape[0])  # per-image → per-window
    out = _counts_by_offset(flat, levels, offsets, quant=quant)
    out = out.reshape(b, gh, gw, len(offsets), levels, levels)
    return out if batched else out[0]


def glcm_window(
    x: torch.Tensor,
    *,
    levels: int,
    offsets: tuple[tuple[int, int], ...],
    region_shape=None,
    stride=None,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """Per-window multi-offset GLCMs (int32), one launch for a whole stack.

    ``x`` is an (H, W) / (B, H, W) image with ``region_shape=(rh, rw)`` and
    ``stride=(sh, sw)`` (default: the region shape, i.e. tiles) → (gh, gw,
    n_off, L, L) / (B, gh, gw, n_off, L, L), the kernel reading each window
    in place; or, without ``region_shape``, an extracted (gh, gw, rh, rw) /
    (B, gh, gw, rh, rw) patch grid (as ``repro``'s ``glcm_window_pallas``
    takes). ``offsets`` are (dy, dx) with 0 <= dy < rh and |dx| < rw. Without
    ``quant`` the values are levels (cast to int32; one outside [0, L) does
    not vote). With ``quant=(lo, span)`` — python floats or per-image (B,)
    tensors — the values are raw and every window bins with its image's
    range, uint8 read as it is (other dtypes as float32). ``copies`` is the
    paper's R; it never changes the counts.
    """
    assert_levels(levels)
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    windows, batched = _windows(x, region_shape, stride)
    rh, rw = windows.shape[-2:]
    for dy, dx in offsets:
        if not (0 <= dy < rh) or abs(dx) >= rw:
            raise ValueError(f"offset (dy={dy}, dx={dx}) does not fit region ({rh}, {rw})")
    out = build.dispatch(
        glcm_window, windows, lambda: glcm_window_plain(windows, levels, offsets, quant=quant),
        lambda: _launch_window(x, region_shape, stride, levels, offsets, copies, quant))
    return out if batched else out[0]


glcm_window.launches = 0


def _launch_window(x, region_shape, stride, levels, offsets, copies, quant) -> torch.Tensor:
    # uint8 is read as it is and int32 levels as they are; no widened copy.
    src, kind = _kernel_input(x, quant)
    windows, _ = _windows(src, region_shape, stride)
    b, gh, gw, rh, rw = windows.shape
    s_img, s_row, s_col, s_y, s_x = windows.stride()
    if s_x != 1:
        raise ValueError(f"window rows must be contiguous, got strides {windows.stride()}")
    q = None if quant is None else _quant_block(quant, b, src.device)
    n_off = len(offsets)
    # Every count is written by the kernel (each window's slot is stored whole).
    out = torch.empty((b, gh, gw, n_off, levels, levels), dtype=torch.int32,
                      device=src.device)
    dy = (ctypes.c_int * n_off)(*(o[0] for o in offsets))
    dx = (ctypes.c_int * n_off)(*(o[1] for o in offsets))
    build.launch(glcm_window, "glcm_window_launch",
                 [_P, _I, _P, _P] + [_I] * 5 + [_LL] * 4 + [_I, _I, _P, _P, _I, _P], src.device,
                 windows.data_ptr(), kind, None if q is None else q.data_ptr(), out.data_ptr(),
                 b, gh, gw, rh, rw, s_img, s_row, s_col, s_y, levels, copies,
                 ctypes.addressof(dy), ctypes.addressof(dx), n_off)
    return out


# ---------------------------------------------------------------------------
# Kernel 4: depth-slab volume pass
# ---------------------------------------------------------------------------


def glcm_volume_plain(
    vol: torch.Tensor,
    levels: int,
    offsets: tuple[tuple[int, int, int], ...],
    *,
    quant=None,
) -> torch.Tensor:
    """Plain version of ``glcm_volume``: (B, D, H, W) → (B, n_off, L, L)
    int32, a masked ``bincount`` over (volume, ref, assoc) per offset,
    binned from raw values (float32, uint8 or any real dtype) when
    ``quant`` is given."""
    return _pairless_zero(_counts_by_offset, vol, levels, tuple(offsets), quant)


def glcm_volume(
    vol: torch.Tensor,
    *,
    levels: int,
    offsets: tuple[tuple[int, int, int], ...],
    slab_d: int = DEFAULT_SLAB_D,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """One pass over volume(s) → multi-direction 3-D GLCMs (int32).

    ``vol`` is (D, H, W) → (n_off, L, L) or (B, D, H, W) → (B, n_off, L, L),
    in one launch. ``offsets`` are (dz, dy, dx) with 0 <= dz <= slab_d,
    |dy| < H and |dx| < W, as the reference kernel requires (dy and dx may
    be negative). Without ``quant`` the values are levels (cast to int32;
    one outside [0, L) does not vote); with ``quant=(lo, span)`` — python
    floats or per-volume (B,) tensors — they are raw and binned once in the
    kernel, uint8 read as it is (other dtypes as float32). ``slab_d`` is the
    fewest depth slices a block marches and ``copies`` the paper's R;
    neither changes the counts.
    """
    if vol.ndim not in (3, 4):
        raise ValueError(f"expected (D, H, W) or (B, D, H, W) volume, got {tuple(vol.shape)}")
    assert_levels(levels)
    offsets = tuple((int(dz), int(dy), int(dx)) for dz, dy, dx in offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if slab_d < 1 or copies < 1:
        raise ValueError(f"slab_d and copies must be >= 1, got {slab_d}, {copies}")
    h, w = vol.shape[-2:]
    for dz, dy, dx in offsets:
        if not (0 <= dz <= slab_d):
            raise ValueError(f"dz={dz} must be in [0, slab_d={slab_d}]")
        if abs(dy) >= h or abs(dx) >= w:
            raise ValueError(f"in-plane offset (dy={dy}, dx={dx}) exceeds plane ({h}, {w})")
    batched = vol.ndim == 4
    stack = vol if batched else vol[None]
    out = build.dispatch(glcm_volume, stack,
                         lambda: glcm_volume_plain(stack, levels, offsets, quant=quant),
                         lambda: _launch_volume(stack, levels, offsets, slab_d, copies, quant))
    return out if batched else out[0]


glcm_volume.launches = 0


def _launch_volume(stack, levels, offsets, slab_d, copies, quant) -> torch.Tensor:
    b, d, h, w = stack.shape
    x, kind = _kernel_input(stack, quant)
    q = None if quant is None else _quant_block(quant, b, stack.device)
    n_off = len(offsets)
    out = torch.zeros((b, n_off, levels, levels), dtype=torch.int32, device=stack.device)
    dz = (ctypes.c_int * n_off)(*(o[0] for o in offsets))
    dy = (ctypes.c_int * n_off)(*(o[1] for o in offsets))
    dx = (ctypes.c_int * n_off)(*(o[2] for o in offsets))
    build.launch(glcm_volume, "glcm_volume_launch",
                 [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P], stack.device,
                 x.data_ptr(), kind, None if q is None else q.data_ptr(), out.data_ptr(),
                 b, d, h, w, levels, copies, slab_d, ctypes.addressof(dz),
                 ctypes.addressof(dy), ctypes.addressof(dx), n_off)
    return out
