"""GLCMSpec — the frozen, hashable description of one GLCM workload.

Counterpart of ``repro.core.spec``, field for field and check for check, so
a spec carries over between the packages as a dict of plain values:
``GLCMSpec.from_dict(dataclasses.asdict(other_spec))``.

A ``GLCMSpec`` captures everything the execution strategy depends on — gray
levels, the offset set, quantization, post-processing, scheme knobs, spatial
rank — as one immutable value, so the execution layer
(``core.plan.compile_plan`` → ``core.backends`` registry) can resolve and
cache a plan for it exactly once per ``(spec, shape, device)``.

A spec is *pure data*: it never touches torch, never dispatches, and is
hashable (usable as a cache key).  Scheme *names* are validated against the
registry only at plan time.

Volumetric workloads: ``ndim=3`` switches the spatial rank from (H, W)
images to (D, H, W) volumes.  Pairs keep the same two-int shape but their
second element becomes one of the 13 unique 3-D direction indices
(``kernels.ref.DIRECTIONS_3D``; 0..3 are the in-plane thetas, 4..12 the
dz = +1 inter-slice directions), validated exactly like the 2-D (d, θ)
set.  Region fields generalize to 3-tuples ((rd, rh, rw) sub-volumes).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.ref import glcm_offsets, glcm_offsets_3d

__all__ = [
    "GLCMSpec",
    "ACCUM_MODES",
    "BATCH_MODES",
    "QUANTIZE_MODES",
    "REGION_MODES",
]

# Valid ``quantize`` modes (``core.quantize``): None passes the image through
# (already quantized), "uniform" rebins linearly, "equalized" equal-population.
QUANTIZE_MODES = (None, "uniform", "equalized")

# Valid ``accum`` (vote/accumulator dtype) modes, as in the reference spec.
# "int" makes the one-hot schemes ("onehot", "blocked") vote in integers
# accumulated in int32; otherwise they vote in float32, exact while a cell
# stays below 2**24. Every other backend counts in integers whatever the
# mode, so the counts are the same for all three.
ACCUM_MODES = ("auto", "int", "float32")

# Valid ``batch_mode`` modes of the reference's TPU kernels ("grid": batch on
# the kernel grid; "unroll": one launch per image).  Accepted for parity and
# ignored: the CUDA kernels always carry the batch as a grid dimension.
BATCH_MODES = ("auto", "grid", "unroll")

# Valid ``region`` modes: "global" is one GLCM per whole image (the classic
# workload), "tiles" one GLCM per cell of a non-overlapping partition (the
# paper's image-partitioning scheme as a user-visible workload), "window" one
# GLCM per sliding window (per-pixel/per-stride texture maps).
REGION_MODES = ("global", "tiles", "window")


def _shape_nd(value, name: str, ndim: int) -> tuple[int, ...]:
    """Canonicalize an int or per-axis tuple to a validated int ``ndim``-tuple."""
    if isinstance(value, int):
        value = (value,) * ndim
    try:
        dims = tuple(int(v) for v in value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be an int or a {ndim}-tuple, got {value!r}"
        ) from None
    if len(dims) != ndim:
        raise ValueError(
            f"{name} must have {ndim} entries for an ndim={ndim} spec, got {dims}"
        )
    if any(s < 1 for s in dims):
        raise ValueError(f"{name} entries must be >= 1, got {dims}")
    return dims


@dataclasses.dataclass(frozen=True)
class GLCMSpec:
    """What to compute: GLCMs of ``levels`` gray levels over ``pairs`` offsets.

    Fields
    ------
    levels      gray levels L of the output (L, L) matrices, in [2, 256].
    pairs       offset tuples; every backend computes ALL of them in one
                program (n_pairs axis of the result). For ``ndim=2`` each is
                (d, θ) with θ ∈ {0, 45, 90, 135}; for ``ndim=3`` each is
                (d, direction) with direction indexing the 13 unique 3-D
                directions of ``kernels.ref.DIRECTIONS_3D``.
    scheme      backend name ("scatter" | "onehot" | "blocked" | "native" |
                "cuda" | "cuda_fused" | "cuda_volume")
                or "auto" (resolved at plan time to the autotuner's stored
                winner for this (spec, shape, device) when there is one —
                see ``core.autotune`` — else from the plan's device and the
                registry's capabilities — see ``core.backends``).
    quantize    pre-quantization mode (see QUANTIZE_MODES), applied per image.
    symmetric   add the transpose (P + Pᵀ) after counting.
    normalize   divide each matrix by its sum (probabilities, not counts).
    copies      the paper's R: number of private sub-accumulators (Scheme 2;
                the CUDA kernels' shared-memory copies). An autotuner knob.
    num_blocks  leading-axis blocks for the blocked scheme (Scheme 3, single
                device): row blocks for images, depth slabs for volumes. An
                autotuner knob.
    vrange      static (vmin, vmax) for uniform quantization; None derives
                the range from each image's own data (the default everywhere
                except the streaming pipeline, which pins 0..255).
    region      workload axis (see REGION_MODES): "global" (default; one GLCM
                per image, bit-exact legacy behavior), "tiles" (one GLCM per
                cell of the non-overlapping ``region_shape`` partition), or
                "window" (one GLCM per sliding ``region_shape`` window at
                ``region_stride``). Non-global outputs gain a region grid
                ((gh, gw), or (gd, gh, gw) for volumes) between the batch
                and n_pairs axes.
    region_shape   tile/window size — (rh, rw), or (rd, rh, rw) for ndim=3
                (an int means a square/cube); required for "tiles"/"window",
                forbidden for "global". Pairs are counted strictly WITHIN
                each region, so every offset must fit inside it.
    region_stride  sliding-window step for "window" (defaults to all-ones: a
                dense per-voxel texture map); forbidden otherwise ("tiles"
                strides by its own shape, by definition).
    ndim        spatial rank of the input: 2 for (H, W) images (the default,
                bit-exact legacy behavior), 3 for (D, H, W) volumes.
    accum       vote/accumulator dtype policy (see ACCUM_MODES). "auto" picks
                per backend and device; integer voting is always exact (counts
                are bounded by plane/block area and widened before reduction),
                the knob only trades execution speed.
    tile_h      fused-kernel row-tile height override (None = the kernel
                default: max(8, largest dy) rounded up to 8). An autotuner
                knob — see ``core.autotune``.
    chunk       pair-stream chunk length override (None = kernel default
                2048). Must be a multiple of ``copies``. An autotuner knob.
    slab_d      volume-kernel depth-slab override (None = max(8, largest dz)
                rounded up to 8); splits the work, never changes the counts.
                An autotuner knob.
    batch_mode  batch-axis topology of the reference's TPU kernels (see
                BATCH_MODES). Accepted and validated for parity; on CUDA the
                batch is always a grid dimension, so no backend reads it.
    """

    levels: int
    pairs: tuple[tuple[int, int], ...] = ((1, 0),)
    scheme: str = "auto"
    quantize: str | None = None
    symmetric: bool = False
    normalize: bool = False
    copies: int = 1
    num_blocks: int = 4
    vrange: tuple[float | None, float | None] | None = None
    region: str = "global"
    region_shape: tuple[int, ...] | int | None = None
    region_stride: tuple[int, ...] | int | None = None
    ndim: int = 2
    accum: str = "auto"
    tile_h: int | None = None
    chunk: int | None = None
    slab_d: int | None = None
    batch_mode: str = "auto"

    def __post_init__(self):
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if not (2 <= self.levels <= 256):
            raise ValueError(f"levels must be in [2, 256], got {self.levels}")
        # Coerce pairs to a canonical hashable tuple-of-int-tuples (callers
        # may hand us lists); validate each offset eagerly.
        pairs = tuple((int(d), int(t)) for d, t in self.pairs)
        object.__setattr__(self, "pairs", pairs)
        if not pairs:
            raise ValueError(
                "spec.pairs must name at least one (d, theta/direction) offset"
            )
        for d, t in pairs:
            # raises ValueError on bad d / theta / 3-D direction index
            glcm_offsets(d, t) if self.ndim == 2 else glcm_offsets_3d(d, t)
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"unknown quantize mode {self.quantize!r}; expected one of {QUANTIZE_MODES}"
            )
        if not isinstance(self.scheme, str) or not self.scheme:
            raise ValueError(f"scheme must be a non-empty string, got {self.scheme!r}")
        if self.copies < 1:
            raise ValueError(f"copies (R) must be >= 1, got {self.copies}")
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {self.num_blocks}")
        if self.accum not in ACCUM_MODES:
            raise ValueError(
                f"unknown accum mode {self.accum!r}; expected one of {ACCUM_MODES}"
            )
        if self.batch_mode not in BATCH_MODES:
            raise ValueError(
                f"unknown batch_mode {self.batch_mode!r}; expected one of "
                f"{BATCH_MODES}"
            )
        for knob in ("tile_h", "chunk", "slab_d"):
            v = getattr(self, knob)
            if v is not None:
                if not isinstance(v, int) or v < 1:
                    raise ValueError(f"{knob} must be a positive int or None, got {v!r}")
        if self.chunk is not None and self.chunk % self.copies:
            raise ValueError(
                f"chunk ({self.chunk}) must be a multiple of copies ({self.copies})"
            )
        if self.vrange is not None:
            vmin, vmax = self.vrange
            object.__setattr__(
                self,
                "vrange",
                (None if vmin is None else float(vmin),
                 None if vmax is None else float(vmax)),
            )
        if self.region not in REGION_MODES:
            raise ValueError(
                f"unknown region mode {self.region!r}; expected one of {REGION_MODES}"
            )
        if self.region == "global":
            if self.region_shape is not None or self.region_stride is not None:
                raise ValueError(
                    'region="global" takes no region_shape/region_stride'
                )
        else:
            if self.region_shape is None:
                raise ValueError(f'region={self.region!r} requires region_shape')
            rshape = _shape_nd(self.region_shape, "region_shape", self.ndim)
            object.__setattr__(self, "region_shape", rshape)
            if self.region == "tiles":
                if self.region_stride is not None:
                    raise ValueError(
                        'region="tiles" strides by its own shape; '
                        "region_stride must be unset"
                    )
            else:
                stride = (1,) * self.ndim if self.region_stride is None else (
                    self.region_stride
                )
                object.__setattr__(
                    self, "region_stride",
                    _shape_nd(stride, "region_stride", self.ndim),
                )
            # Pairs are counted within each region: every offset must fit.
            # The leading spatial delta is non-negative by construction
            # (dy >= 0 in 2-D, dz >= 0 in 3-D); the rest may be negative.
            for (d, t), off in zip(pairs, self.offsets()):
                if off[0] >= rshape[0] or any(
                    abs(o) >= s for o, s in zip(off[1:], rshape[1:])
                ):
                    raise ValueError(
                        f"offset (d={d}, {t}) → {off} does not fit inside "
                        f"region_shape {rshape}"
                    )

    @property
    def n_pairs(self) -> int:
        return len(self.pairs)

    @property
    def strides(self) -> tuple[int, ...] | None:
        """Effective region stride: tiles step by their own shape."""
        if self.region == "global":
            return None
        return self.region_shape if self.region == "tiles" else self.region_stride

    def region_grid(self, *dims: int) -> tuple[int, ...]:
        """The region grid for ``dims`` spatial extents; () for "global".

        ``dims`` is (h, w) for ndim=2 or (d, h, w) for ndim=3. Raises
        ValueError when the input cannot host the configured regions
        (non-divisible tile partition, window larger than the input).
        """
        if self.region == "global":
            return ()
        if len(dims) != self.ndim:
            raise ValueError(
                f"expected {self.ndim} spatial extents for an ndim={self.ndim} "
                f"spec, got {dims}"
            )
        rshape = self.region_shape
        if self.region == "tiles":
            if any(s % r for s, r in zip(dims, rshape)):
                raise ValueError(
                    f"input shape {tuple(dims)} not divisible into "
                    f"region_shape={rshape} tiles"
                )
            return tuple(s // r for s, r in zip(dims, rshape))
        if any(r > s for r, s in zip(rshape, dims)):
            raise ValueError(
                f"window region_shape {rshape} exceeds input shape {tuple(dims)}"
            )
        return tuple(
            (s - r) // st + 1 for s, r, st in zip(dims, rshape, self.region_stride)
        )

    def offsets(self) -> tuple[tuple[int, ...], ...]:
        """Per-axis spatial offsets for every pair, in pair order: (dy, dx)
        tuples for ndim=2, (dz, dy, dx) tuples for ndim=3."""
        if self.ndim == 2:
            return tuple(glcm_offsets(d, t) for d, t in self.pairs)
        return tuple(glcm_offsets_3d(d, t) for d, t in self.pairs)

    def single_pair(self) -> tuple[int, int]:
        """The sole offset pair, for single-offset consumers (sharded GLCM)."""
        if len(self.pairs) != 1:
            raise ValueError(
                f"expected a single-offset spec, got {len(self.pairs)} pairs"
            )
        return self.pairs[0]

    def replace(self, **changes) -> "GLCMSpec":
        """A copy of this spec with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_dict(cls, d: dict) -> "GLCMSpec":
        """The spec described by ``d``, a dict of plain values such as
        ``dataclasses.asdict(spec)`` of this class or of the reference
        package's ``GLCMSpec``. Missing keys take their defaults; unknown
        keys raise ValueError. The usual validation runs."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown GLCMSpec fields {unknown}")
        return cls(**d)
