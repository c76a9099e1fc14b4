"""The CPU voting schemes, in PyTorch: the backends "scatter", "onehot" and
"blocked".

Counterpart of ``repro.core.schemes``:

  Scheme 1 (contended atomic voting)  → ``glcm_scatter`` (one image) and
                                         ``glcm_scatter_batch`` (``bincount``
                                         over the linearized ``ref*L+assoc``)
  Scheme 2 (R-copy privatized voting) → ``glcm_onehot`` / ``glcm_multi``
                                         (one-hot matmul ``RᵀA`` per copy)
  Scheme 3 (blocks with a halo)       → ``glcm_blocked`` (row blocks or
                                         depth slabs, -1 sentinel halo)
  Regions (texture maps)              → ``extract_regions`` and
                                         ``glcm_windowed`` (one GLCM per
                                         tile or sliding window)

Inputs are quantized int images, or — with ``quant=(lo, span)`` — raw
pixels binned on the fly by ``core.quantize.bin_values``, applied to the
sliced pair planes and never to the whole image. The batch is an explicit
leading dimension (the reference vmaps): a stack with one axis more than the
offset's rank is a batch. Votes whose level lies outside [0, L) are dropped,
as the reference's one-hot compare drops them.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import bin_values, repeat_params
from repro_torch.kernels.ref import DIRECTIONS_3D, glcm_offsets, pair_planes_nd

__all__ = [
    "glcm_scatter",
    "glcm_scatter_batch",
    "glcm_onehot",
    "glcm_multi",
    "glcm_blocked",
    "local_partial_nd",
    "extract_regions",
    "glcm_windowed",
    "PAPER_PAIRS",
    "VOLUME_PAIRS",
]

# The paper's Table II / III parameter grid: d ∈ {1, 4}, θ ∈ {0°, 45°}.
PAPER_PAIRS: tuple[tuple[int, int], ...] = ((1, 0), (1, 45), (4, 0), (4, 45))

# All 13 unique 3-D directions at distance 1 (pairs for an ndim=3 spec).
VOLUME_PAIRS: tuple[tuple[int, int], ...] = tuple(
    (1, k) for k in range(len(DIRECTIONS_3D))
)


def _per_image(quant, b: int, nd: int, device):
    """(lo, span) as (B, 1, ..., 1) f32 tensors broadcasting over ``nd``
    spatial axes: each image of a stack is binned with its own range."""
    shape = (b,) + (1,) * nd
    lo = torch.as_tensor(quant[0], dtype=torch.float32, device=device)
    span = torch.as_tensor(quant[1], dtype=torch.float32, device=device)
    return lo.expand(b).reshape(shape), span.expand(b).reshape(shape)


def _levels_of(plane: torch.Tensor, levels: int, quant) -> torch.Tensor:
    """Pair-plane values → int64 levels (binned when ``quant`` is given)."""
    if quant is None:
        return plane.to(torch.int64)
    return bin_values(plane, levels, *quant).to(torch.int64)


def _as_stack(img: torch.Tensor, nd: int) -> tuple[torch.Tensor, bool]:
    if img.ndim == nd + 1:
        return img, True
    if img.ndim != nd:
        raise ValueError(
            f"expected a {nd}-D input or a batched {nd + 1}-D stack, got shape "
            f"{tuple(img.shape)}"
        )
    return img[None], False


def glcm_scatter(
    img: torch.Tensor,
    levels: int,
    d: int = 1,
    theta: int = 0,
    *,
    offset: tuple[int, ...] | None = None,
    symmetric: bool = False,
    normalize: bool = False,
    quant=None,
) -> torch.Tensor:
    """Scheme 1 for one image: every pixel pair votes into one shared (L, L)
    accumulator (a ``bincount``, the counterpart of contended atomics).

    ``offset`` (an explicit (dy, dx) / (dz, dy, dx) tuple) overrides
    (d, theta). ``img`` is (*spatial) → (L, L) or (B, *spatial) →
    (B, L, L) float32, each image binned with its own entry of per-image
    ``quant=(lo, span)``; symmetric and normalize apply per image.
    """
    if offset is None:
        off = glcm_offsets(d, theta)
    else:
        off = tuple(int(v) for v in offset)
        if len(off) not in (2, 3):
            raise ValueError(f"offset must be (dy, dx) or (dz, dy, dx), got {offset!r}")
    stack, batched = _as_stack(img, len(off))
    glcm = glcm_scatter_batch(stack, levels, (off,), quant=quant)[:, 0]
    if symmetric:
        glcm = glcm + glcm.transpose(-1, -2)
    glcm = glcm.to(torch.float32)
    if normalize:
        glcm = glcm / glcm.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)
    return glcm if batched else glcm[0]


def glcm_scatter_batch(
    stack: torch.Tensor,
    levels: int,
    offsets: tuple[tuple[int, ...], ...],
    *,
    quant=None,
) -> torch.Tensor:
    """Scheme 1 for a (B, *spatial) stack: one flat ``bincount`` over
    ``pos = (b·n_off + k)·L² + ref·L + assoc`` for all images and offsets.
    Returns (B, n_off, L, L) int32 counts."""
    b = stack.shape[0]
    n_off = len(offsets)
    cells = levels * levels
    nd = stack.ndim - 1
    if quant is not None:
        quant = _per_image(quant, b, nd, stack.device)
    base = torch.arange(b, device=stack.device).reshape((b,) + (1,) * nd) * (n_off * cells)
    parts = []
    for k, off in enumerate(offsets):
        assoc, ref = pair_planes_nd(stack, off)
        a = _levels_of(assoc, levels, quant)
        r = _levels_of(ref, levels, quant)
        valid = (a >= 0) & (a < levels) & (r >= 0) & (r < levels)
        parts.append((base + k * cells + r * levels + a)[valid])
    counts = torch.bincount(torch.cat(parts), minlength=b * n_off * cells)
    return counts.reshape(b, n_off, levels, levels).to(torch.int32)


def _onehot(v: torch.Tensor, levels: int, dtype=torch.float32) -> torch.Tensor:
    """(..., P) int → (..., P, L) one-hot (f32 unless ``dtype``); a value
    outside [0, L) (the -1 pad included) gives an all-zero row, so its vote
    drops."""
    iota = torch.arange(levels, device=v.device)
    return (v[..., None] == iota).to(dtype)


def _vote_dtype(int_votes: bool, device: torch.device) -> torch.dtype:
    """The one-hot vote dtype: float32 (exact while a cell stays below 2²⁴),
    or, for ``int_votes``, an integer whose matmul accumulates in int32 —
    int32 on the CPU, whose ``bmm`` takes it, and int8 on the card, where
    PyTorch's only integer matmul is ``torch._int_mm`` (int8 × int8 → int32)."""
    if not int_votes:
        return torch.float32
    return torch.int8 if device.type == "cuda" else torch.int32


def _votes(R: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The vote matmul of (N, P, L) one-hot ref and assoc matrices →
    (N, L, L) counts ``Σ_p R_pᵀ A_p``, in the one-hots' dtype (int32 for
    int8 one-hots)."""
    if R.dtype == torch.int8:
        return _int_mm_votes(R, A)
    return torch.einsum("npi,npj->nij", R, A)


def _int_mm_votes(R: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``_votes`` for int8 one-hots by ``torch._int_mm``, one product per
    item: it takes 2-D operands only, with more than 16 rows and a
    contraction and column count that are multiples of 8, so the one-hots
    are zero-padded to that (a zero row or column votes nowhere)."""
    n, p, levels = R.shape
    up8 = lambda v: -(-v // 8) * 8  # noqa: E731
    rows, cols, k = max(24, up8(levels)), up8(levels), up8(max(p, 1))
    rt = torch.zeros((n, rows, k), dtype=torch.int8, device=R.device)
    rt[:, :levels, :p] = R.transpose(1, 2)
    at = torch.zeros((n, k, cols), dtype=torch.int8, device=A.device)
    at[:, :p, :levels] = A
    out = torch.empty((n, levels, levels), dtype=torch.int32, device=R.device)
    for i in range(n):
        out[i] = torch._int_mm(rt[i], at[i])[:levels, :levels]
    return out


def local_partial_nd(
    ext: torch.Tensor, levels: int, offset: tuple[int, ...], local_n: int
) -> torch.Tensor:
    """Partial GLCM of a leading-axis shard extended with halo slices, by the
    one-hot matmul ``RᵀA`` (the plain version of the sharded hook of
    ``core.distributed``).

    ``ext`` is (*batch, local_n + offset[0], *rest) integer levels — a row
    shard of an image for 2-D offsets, a depth slab of a volume for 3-D
    offsets, each optionally under leading batch dims — with -1 sentinels
    for out-of-input halo elements. The leading delta is realized by the
    halo; the remaining (possibly negative) deltas are sliced within the
    shard's resident planes. A vote with either side outside [0, L) drops.
    Returns exact int32 (*batch, L, L) counts: the one-hots are float64,
    whose integer sums are exact far past any int32 count.
    """
    lead = ext.ndim - len(offset)
    d0 = offset[0]
    assoc = ext.narrow(lead, 0, local_n)
    ref = ext.narrow(lead, d0, local_n)
    for ax, delta in enumerate(offset[1:], start=lead + 1):
        size = ext.shape[ax]
        if delta >= 0:
            assoc = assoc.narrow(ax, 0, size - delta)
            ref = ref.narrow(ax, delta, size - delta)
        else:
            assoc = assoc.narrow(ax, -delta, size + delta)
            ref = ref.narrow(ax, 0, size + delta)
    batch = ext.shape[:lead]
    a = _onehot(assoc.reshape(*batch, -1), levels, torch.float64)
    r = _onehot(ref.reshape(*batch, -1), levels, torch.float64)
    return (r.mT @ a).to(torch.int32)


def glcm_onehot(
    img: torch.Tensor,
    levels: int,
    offset: tuple[int, ...] = (0, 1),
    *,
    copies: int = 1,
    quant=None,
    int_votes: bool = False,
) -> torch.Tensor:
    """Scheme 2: the GLCM is the matmul ``RᵀA`` of the one-hot ref/assoc
    matrices. ``copies`` (the paper's R) splits the pair stream into R
    sub-streams with private (L, L) sub-accumulators, summed at the end.

    ``img`` is (*spatial) → (L, L) or (B, *spatial) → (B, L, L): float32
    counts, exact while every cell stays below 2²⁴, or with ``int_votes``
    integer votes accumulated in exact int32 (the reference's
    ``accum="int"``; see ``_vote_dtype``). Symmetric/normalize are the
    plan's tail.
    """
    if copies < 1:
        raise ValueError(f"copies (R) must be >= 1, got {copies}")
    nd = len(offset)
    stack, batched = _as_stack(img, nd)
    b = stack.shape[0]
    if quant is not None:
        quant = _per_image(quant, b, nd, stack.device)
    assoc, ref = pair_planes_nd(stack, offset)
    a = _levels_of(assoc, levels, quant).reshape(b, -1)
    r = _levels_of(ref, levels, quant).reshape(b, -1)
    pad = (-a.shape[1]) % copies
    if pad:  # dead votes pad the stream to a multiple of R
        a = torch.nn.functional.pad(a, (0, pad), value=-1)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    dt = _vote_dtype(int_votes, stack.device)
    A = _onehot(a.reshape(b * copies, -1), levels, dt)  # (B·R, P/R, L)
    R = _onehot(r.reshape(b * copies, -1), levels, dt)
    glcm = _votes(R, A).reshape(b, copies, levels, levels).sum(dim=1)  # Σ_ρ R_ρᵀ A_ρ
    if int_votes:
        glcm = glcm.to(torch.int32)  # the sum over copies widens to int64
    return glcm if batched else glcm[0]


def glcm_multi(
    img: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...] = PAPER_PAIRS,
    *,
    offsets: tuple[tuple[int, ...], ...] | None = None,
    copies: int = 1,
    quant=None,
    int_votes: bool = False,
) -> torch.Tensor:
    """GLCMs for several offsets: ``pairs`` are 2-D (d, θ) tuples;
    ``offsets`` (explicit (dy, dx) / (dz, dy, dx) tuples) overrides them.
    Returns (n_off, L, L), batch axis leading if present; ``int_votes`` as
    in ``glcm_onehot``."""
    if offsets is None:
        offsets = tuple(glcm_offsets(d, t) for d, t in pairs)
    return torch.stack(
        [
            glcm_onehot(img, levels, off, copies=copies, quant=quant,
                        int_votes=int_votes)
            for off in offsets
        ],
        dim=-3,
    )


# ---------------------------------------------------------------------------
# Regions (texture maps)
# ---------------------------------------------------------------------------


def extract_regions(
    img: torch.Tensor,
    region_shape: tuple[int, ...],
    stride: tuple[int, ...],
) -> torch.Tensor:
    """The region grid of (..., H, W) images or (..., D, H, W) volumes; the
    spatial rank is ``len(region_shape)``.

    Returns (..., *grid, *region_shape), e.g. (..., gh, gw, rh, rw). A stride
    equal to the region shape that divides the input is the non-overlapping
    tiling, a reshape and permute (no copy); any other stride gives sliding
    windows, gathered with one index on the trailing spatial axes and
    shared by every leading dim. Window positions that do not fit are
    dropped: ``grid = (size - region) // stride + 1`` per axis.
    """
    nd = len(region_shape)
    if len(stride) != nd:
        raise ValueError(f"stride {stride} rank != region_shape {region_shape}")
    dims = tuple(img.shape[-nd:])
    if any(r > s for r, s in zip(region_shape, dims)):
        raise ValueError(f"region {region_shape} exceeds input shape {dims}")
    lead = tuple(img.shape[:-nd])
    nlead = len(lead)
    if tuple(stride) == tuple(region_shape) and not any(
        s % r for s, r in zip(dims, region_shape)
    ):
        grid = tuple(s // r for s, r in zip(dims, region_shape))
        inter = sum(((g, r) for g, r in zip(grid, region_shape)), ())
        # lead + (g0, r0, g1, r1, ...) → lead + (g0, g1, ..., r0, r1, ...)
        perm = (
            tuple(range(nlead))
            + tuple(nlead + 2 * i for i in range(nd))
            + tuple(nlead + 2 * i + 1 for i in range(nd))
        )
        return img.reshape(lead + inter).permute(perm)
    grid = tuple((s - r) // st + 1 for s, r, st in zip(dims, region_shape, stride))
    index: list = [Ellipsis]
    for i in range(nd):
        ar = (
            stride[i] * torch.arange(grid[i], device=img.device)[:, None]
            + torch.arange(region_shape[i], device=img.device)[None, :]
        )  # (g_i, r_i)
        shape = [1] * (2 * nd)
        shape[i] = grid[i]
        shape[nd + i] = region_shape[i]
        index.append(ar.reshape(shape))
    return img[tuple(index)]


def glcm_windowed(
    img: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...],
    region_shape: tuple[int, ...],
    stride: tuple[int, ...],
    *,
    offsets: tuple[tuple[int, ...], ...] | None = None,
    copies: int = 1,
    quant=None,
    int_votes: bool = False,
) -> torch.Tensor:
    """Per-region GLCMs: one region extraction, then the one-hot matmul
    ``RᵀA`` per window and copy, with the flat window grid as the batch.

    (H, W) → (gh, gw, n_pairs, L, L); (B, H, W) → (B, gh, gw, n_pairs, L, L);
    volumes gain the (gd, gh, gw) grid of (rd, rh, rw) sub-volumes
    (``offsets`` carries the 3-D directions). Pairs are counted strictly
    within each region. With ``quant=(lo, span)`` the patches are raw and
    every window bins with its image's range (per-image (B,) tensors repeat
    over the image's windows). float32 counts, or int32 with ``int_votes``
    (as in ``glcm_onehot``).
    """
    if copies < 1:
        raise ValueError(f"copies (R) must be >= 1, got {copies}")
    if offsets is None:
        offsets = tuple(glcm_offsets(d, t) for d, t in pairs)
    nd = len(region_shape)
    patches = extract_regions(img, region_shape, stride)
    lead = tuple(patches.shape[:-nd])
    flat = patches.reshape((-1,) + tuple(patches.shape[-nd:]))
    if quant is not None:
        quant = repeat_params(quant, flat.shape[0])
    else:
        flat = flat.to(torch.int32)
    mats = glcm_multi(flat, levels, offsets=offsets, copies=copies, quant=quant,
                      int_votes=int_votes)
    return mats.reshape(lead + (len(offsets), levels, levels))


# ---------------------------------------------------------------------------
# Scheme 3 — blocks along the leading spatial axis, with a halo
# ---------------------------------------------------------------------------


def glcm_blocked(
    img: torch.Tensor,
    levels: int,
    d: int = 1,
    theta: int = 0,
    *,
    offset: tuple[int, ...] | None = None,
    num_blocks: int = 4,
    int_votes: bool = False,
) -> torch.Tensor:
    """Scheme 3 (paper Eq. (7)–(9)) on one device: the input is split into
    ``num_blocks`` blocks along its leading spatial axis (row blocks for
    images, depth slabs for volumes), each extended by the halo — the
    offset's leading delta ``d0`` — so that boundary pairs count exactly
    once. The trailing edge is padded with ``d0`` slices of -1, which never
    vote. Blocks are voted one after another (the reference's ``lax.scan``)
    by a one-hot matmul over the batch.

    ``img`` is (*spatial) → (L, L) or (B, *spatial) → (B, L, L), float32
    counts, or int32 with ``int_votes`` (as in ``glcm_onehot``). The leading
    extent must divide into ``num_blocks`` blocks of at least ``d0`` slices.
    """
    if offset is None:
        off = glcm_offsets(d, theta)
    else:
        off = tuple(int(v) for v in offset)
        if len(off) not in (2, 3):
            raise ValueError(f"offset must be (dy, dx) or (dz, dy, dx), got {offset!r}")
    nd = len(off)
    stack, batched = _as_stack(img, nd)
    stack = stack.to(torch.int32)  # signed, so the -1 halo survives uint8 input
    b, n0 = stack.shape[0], stack.shape[1]
    d0 = off[0]
    if d0 < 0:
        raise ValueError(f"blocked scheme needs a non-negative leading delta, got {off}")
    if n0 % num_blocks:
        raise ValueError(f"leading extent {n0} not divisible by num_blocks={num_blocks}")
    bh = n0 // num_blocks
    if d0 > bh:
        raise ValueError(f"halo {d0} exceeds block extent {bh}")
    # F.pad lists the last axis first: pad only the trailing end of axis 1.
    padded = torch.nn.functional.pad(stack, (0, 0) * (nd - 1) + (0, d0), value=-1)
    dt = _vote_dtype(int_votes, stack.device)
    glcm = torch.zeros((b, levels, levels),
                       dtype=torch.int32 if int_votes else torch.float32, device=stack.device)
    for i in range(num_blocks):
        block = padded[:, i * bh: (i + 1) * bh + d0]
        assoc, ref = pair_planes_nd(block, off)
        a = assoc.reshape(b, -1).to(torch.int64)
        r = ref.reshape(b, -1).to(torch.int64)
        valid = (a >= 0) & (r >= 0)
        A = _onehot(torch.where(valid, a, -1), levels, dt)
        R = _onehot(torch.where(valid, r, -1), levels, dt)
        glcm += _votes(R, A)
    return glcm if batched else glcm[0]
