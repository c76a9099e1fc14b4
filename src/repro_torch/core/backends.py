"""The scheme registry — every GLCM execution strategy behind ONE contract.

Counterpart of ``repro.core.backends``. Each backend implements

    compute(img_batch, spec, quant=None) -> (B, n_pairs, L, L) counts

where ``img_batch`` is an int32 stack of levels — (B, H, W), or (B, D, H, W)
for ``spec.ndim == 3`` — and ``spec`` is resolved (no "auto"). With
``quant=(lo, span)`` (python floats, or per-image (B,) tensors) the stack
holds RAW pixels that the backend bins where it consumes them
(``caps.fused_quantize``); no quantized full-size image is made. Counts come
back as exact int32, past 2²⁴ too (the reference widens them to float32,
which rounds a cell past 2²⁴): the kernels and "scatter" count in integers;
the one-hot schemes ("onehot", "blocked") vote in float32 (integral, exact
below 2²⁴) or, under ``spec.accum == "int"``, in integers accumulated in
int32, and hand back int32 either way. Quantization ranges,
symmetric/normalize and features are the plan's job (``core.plan``).

Region specs (tiles, sliding windows) go through :func:`compute_regions`:
a backend that declares ``caps.region_grid`` serves them natively through
``region_compute`` → (B, *grid, n_pairs, L, L); any other backend gets the
extracted patches as a flat batch through ``compute``.

Built-in strategies:

  "scatter"      paper Scheme 1: one masked ``bincount`` (CPU or card)
  "onehot"       paper Scheme 2: one-hot matmul ``RᵀA`` per copy (CPU);
                 native region path ``schemes.glcm_windowed``
  "blocked"      paper Scheme 3: row blocks / depth slabs with a halo (CPU)
  "cuda"         pair-stream CUDA vote kernel (``kernels.glcm_vote``)
  "cuda_fused"   fused multi-offset CUDA kernel (``kernels.glcm_fused``);
                 native region path through the window kernel
                 (``kernels.glcm_window``)
  "cuda_volume"  depth-slab CUDA volume kernel (``kernels.glcm_volume``),
                 ndim=3 only
  "native"       NumPy ``bincount`` on the host (``core.native``); the plan
                 calls its ``host_fn`` directly (``caps.host_native``)

Three backends also give the per-shard partials of ``core.distributed``
(``caps.sharded_partial``, ``local_partial``): "onehot" by the one-hot
matmul, "cuda_fused" and "cuda_volume" by one launch of their kernel on the
halo-extended shard, each as exact int32 counts.

"auto" resolves to a stored autotuner winner for the workload and device
when there is one (``core.autotune``, consulted by ``core.plan``), else per
device by the reference's TPU rule: on CUDA ``cuda_volume`` for volumes,
else ``cuda_fused`` for more than one pair and ``cuda`` for one; on the CPU
``onehot``. The rule never picks ``native``: only its name or a measured
win does. The CUDA backends run on a CPU
tensor too — through their kernels' plain versions — which is how the CPU
tests reach their plumbing.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.analysis.scopes import scope
from repro_torch.core import native as _native
from repro_torch.core.quantize import repeat_params
from repro_torch.core.schemes import (
    extract_regions,
    glcm_blocked,
    glcm_multi,
    glcm_scatter_batch,
    glcm_windowed,
    local_partial_nd,
)
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels.glcm_kernel import glcm_fused, glcm_volume, kernel_kind, launch_plan

__all__ = [
    "Backend",
    "Capabilities",
    "available_backends",
    "compute_regions",
    "count_route",
    "get_backend",
    "register",
    "resolve_scheme",
    "supports_ndim",
    "unregister",
]


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend's strategy supports (declared, not probed)."""

    multi_offset_fused: bool = False  # all offsets in ONE device pass
    batch_grid: bool = False          # the batch is a kernel grid dimension
    region_grid: bool = False         # native per-region path (texture maps)
    volumetric: bool = False          # serves ndim=3 (D, H, W) volume specs
    volume_only: bool = False         # serves ONLY ndim=3 specs (implies
    #                                   volumetric; enforced at register())
    fused_quantize: bool = False      # accepts raw pixels + quant=(lo, span)
    host_native: bool = False         # also exposes host_fn: NumPy counting
    #                                   the plan calls outside PyTorch
    device_kernel: bool = False       # launches a CUDA kernel on a CUDA tensor
    #                                   (its plain version on a CPU tensor, so
    #                                   no autotune candidate for a CPU plan)
    sharded_partial: bool = False     # supplies sentinel-masked partials for
    #                                   halo-exchange sharding (distributed.*)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution strategy.

    ``validate(spec, shape)`` (optional) rejects spec/shape combinations the
    strategy cannot serve (e.g. blocked with a height that does not divide)
    before any work; for region specs ``shape`` is the per-region batch it
    will see. ``local_partial(ext, levels, offset, local_n)`` (present iff
    ``caps.sharded_partial``) is the per-shard hook of ``core.distributed``:
    the exact int32 (L, L) partial GLCM of a leading-axis shard extended
    with halo slices, -1 sentinels dropped — ``offset`` is the per-axis
    (dy, dx) / (dz, dy, dx) tuple and ``local_n`` the shard's un-extended
    leading extent; leading batch dims of ``ext`` give (*batch, L, L). ``region_compute(img_batch, spec, quant=None)`` (present iff
    ``caps.region_grid``) serves non-global specs natively, returning
    (B, *grid, n_pairs, L, L). ``host_fn(stack_np, spec, quant)`` (present
    iff ``caps.host_native``) counts a (B, *spatial) ndarray into an integer
    count ndarray, regions included. ``route(shape, spec, kind)``
    (optional) says, without launching, where the kernel that
    ``compute_regions`` reaches on the card for a (B, *spatial) input of
    ``shape`` and ``kind`` (``glcm_kernel.kernel_kind``) keeps its votes
    (see :func:`count_route`).
    """

    name: str
    compute: Callable[..., torch.Tensor]
    caps: Capabilities = Capabilities()
    validate: Callable[[GLCMSpec, tuple[int, ...]], None] | None = None
    local_partial: Callable[..., torch.Tensor] | None = None
    region_compute: Callable[..., torch.Tensor] | None = None
    host_fn: Callable[..., np.ndarray] | None = None
    route: Callable[[tuple[int, ...], GLCMSpec, int], dict] | None = None


def supports_ndim(backend: Backend, ndim: int) -> bool:
    """Whether ``backend`` can serve specs of spatial rank ``ndim``."""
    if ndim == 3:
        return backend.caps.volumetric
    return not backend.caps.volume_only


def compute_regions(
    backend: Backend, img_batch: torch.Tensor, spec: GLCMSpec, quant=None
) -> torch.Tensor:
    """Region-aware dispatch: (B, *spatial) → (B, *grid, n_pairs, L, L).

    "global" specs go straight to ``backend.compute`` (grid = ()). Other
    specs use the backend's ``region_compute`` when it declares
    ``caps.region_grid``; otherwise the patch grid is extracted once and fed
    through ``backend.compute`` as a flat (B·prod(grid), *region_shape)
    batch, so every backend serves tiles and windows, 2-D and 3-D. Per-image
    (B,) quantization ranges repeat over each image's windows: every window
    bins with its image's range.
    """
    if spec.region == "global":
        return backend.compute(img_batch, spec, quant=quant)
    if backend.caps.region_grid:
        return backend.region_compute(img_batch, spec, quant=quant)
    patches = extract_regions(img_batch, spec.region_shape, spec.strides)
    nd = spec.ndim
    b = patches.shape[0]
    grid = tuple(patches.shape[1: 1 + nd])
    flat = patches.reshape((-1,) + tuple(patches.shape[1 + nd:]))
    if quant is not None:
        quant = repeat_params(quant, flat.shape[0])
    mats = backend.compute(flat, spec, quant=quant)
    return mats.reshape((b,) + grid + tuple(mats.shape[1:]))


def count_route(backend: Backend, img_batch: torch.Tensor, spec: GLCMSpec,
                quant=None) -> dict:
    """Where :func:`compute_regions`' count of ``img_batch`` keeps its votes:
    ``hist`` "shared" (``copies`` private sub-histogram sets in shared
    memory, merged into the output at block exit), "cluster" (the counts
    of half the offsets spread over the shared memory of a cluster of
    ``cluster`` blocks, merged at exit, the rest voted with global atomics;
    ``copies`` 1) or "global" (global atomics straight into the output;
    ``copies`` 1), from the kernel's launch plan
    (``glcm_kernel.launch_plan``), which launches nothing and reads nothing
    back; "plain" (``copies`` 0) on the CPU, where the kernels' plain
    versions count. Empty for a backend on the card that declares no
    ``route`` (only ``cuda_fused`` does, for whole images)."""
    if img_batch.device.type != "cuda":
        return {"hist": "plain", "copies": 0}
    if backend.route is None:
        return {}
    return backend.route(tuple(img_batch.shape), spec, kernel_kind(img_batch.dtype, quant))



_REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Add ``backend`` to the registry; its name becomes a scheme name."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} is already registered")
    if backend.name == "auto":
        raise ValueError('"auto" is reserved for scheme resolution')
    if backend.caps.region_grid != (backend.region_compute is not None):
        raise ValueError(
            f"backend {backend.name!r}: caps.region_grid must match the "
            "presence of region_compute"
        )
    if backend.caps.volume_only and not backend.caps.volumetric:
        raise ValueError(
            f"backend {backend.name!r}: caps.volume_only requires "
            "caps.volumetric"
        )
    if backend.caps.host_native != (backend.host_fn is not None):
        raise ValueError(
            f"backend {backend.name!r}: caps.host_native must match the "
            "presence of host_fn"
        )
    if backend.caps.sharded_partial != (backend.local_partial is not None):
        raise ValueError(
            f"backend {backend.name!r}: caps.sharded_partial must match the "
            "presence of local_partial"
        )
    _REGISTRY[backend.name] = backend
    return backend


def unregister(name: str) -> None:
    """Remove a registered backend."""
    try:
        del _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_scheme(
    spec: GLCMSpec, device: torch.device, *, require: tuple[str, ...] = ()
) -> str:
    """Resolve ``spec.scheme`` (possibly "auto") to a registered backend name
    for a plan on ``device``.

    "auto" picks, on CUDA, the depth-slab kernel for ndim=3 specs, the
    fused kernel when a 2-D spec has more than one pair and the pair-stream
    kernel otherwise (the reference's TPU rule); on the CPU the one-hot
    scheme. ``require`` names :class:`Capabilities` fields the backend must
    declare; "auto" then picks the first capable backend by name, leaving
    out the host-native ones unless ``host_native`` is required. The device
    decides which come first: on CUDA the device-kernel backends (so
    ``sharded_partial`` gives ``cuda_fused`` for 2-D and ``cuda_volume`` for
    3-D), on the CPU the others (``onehot``, the reference's answer); a CPU
    plan takes a device-kernel backend, which runs its plain version there,
    only when no other has the capabilities (``batch_grid``).
    """
    if spec.scheme != "auto":
        get_backend(spec.scheme)  # existence check; capability check in plan
        return spec.scheme
    if require:
        on_card = device.type == "cuda"
        names = sorted(available_backends(),
                       key=lambda n: _REGISTRY[n].caps.device_kernel != on_card)
        for name in names:
            backend = _REGISTRY[name]
            if backend.caps.host_native and "host_native" not in require:
                continue
            if supports_ndim(backend, spec.ndim) and all(
                getattr(backend.caps, cap) for cap in require
            ):
                return name
        raise ValueError(
            f"no registered backend has capabilities {require!r} "
            f"for an ndim={spec.ndim} spec"
        )
    if device.type == "cuda":
        if spec.ndim == 3:
            return "cuda_volume"
        return "cuda_fused" if spec.n_pairs > 1 else "cuda"
    return "onehot"


# ---------------------------------------------------------------------------
# The seven built-in strategies
# ---------------------------------------------------------------------------


def _scatter_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return glcm_scatter_batch(img, spec.levels, spec.offsets(), quant=quant)


def _onehot_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return glcm_multi(
        img, spec.levels, offsets=spec.offsets(), copies=spec.copies, quant=quant,
        int_votes=spec.accum == "int",
    ).to(torch.int32)


def _cuda_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    chunk = spec.chunk if spec.chunk is not None else kops.DEFAULT_CHUNK
    return torch.stack(
        [
            kops.glcm_cuda(
                img, spec.levels, offset=off, chunk=chunk,
                copies=max(spec.copies, 1), quant=quant,
            )
            for off in spec.offsets()
        ],
        dim=-3,
    )


def _onehot_region_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return glcm_windowed(
        img, spec.levels, spec.pairs, spec.region_shape, spec.strides,
        offsets=spec.offsets(), copies=spec.copies, quant=quant,
        int_votes=spec.accum == "int",
    ).to(torch.int32)


def _blocked_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    if quant is not None:  # caps.fused_quantize is False; the plan never does this
        raise ValueError("blocked backend does not support fused quantization")
    return torch.stack(
        [
            glcm_blocked(img, spec.levels, offset=off, num_blocks=spec.num_blocks,
                         int_votes=spec.accum == "int")
            for off in spec.offsets()
        ],
        dim=-3,
    ).to(torch.int32)


def _blocked_validate(spec: GLCMSpec, shape: tuple[int, ...]) -> None:
    n0 = shape[-spec.ndim]
    if n0 % spec.num_blocks:
        raise ValueError(
            f"image height {n0} not divisible by num_blocks={spec.num_blocks}"
            if spec.ndim == 2
            else f"volume depth {n0} not divisible by num_blocks={spec.num_blocks}"
        )
    bh = n0 // spec.num_blocks
    for (d, t), off in zip(spec.pairs, spec.offsets()):
        if off[0] > bh:
            raise ValueError(
                f"halo {off[0]} of offset (d={d}, {t}) exceeds block height {bh}"
            )


def _cuda_fused_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return kops.glcm_cuda_multi(
        img, spec.levels, spec.pairs, tile_h=spec.tile_h, copies=spec.copies,
        quant=quant,
    )


def _cuda_fused_local_partial(ext, levels, offset, local_n) -> torch.Tensor:
    # One launch over the whole extended shard: a pair whose assoc pixel lies
    # in a halo row would need its ref pixel below the extension, so the
    # kernel counts exactly the shard's pairs; -1 halo levels do not vote.
    # The int32 counts are returned as they are (exact past 2**24). A batch
    # of shards is one launch.
    offsets = (tuple(offset),)
    return glcm_fused(ext, levels=levels, offsets=offsets,
                      tile_h=kops.default_tile_h(offsets))[..., 0, :, :]


def _cuda_fused_region_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    # The window kernel reads each window of the (B, H, W) stack in place and
    # bins it with its image's (lo, span): no patch grid is made.
    return kops.glcm_cuda_windowed(
        img, spec.levels, spec.pairs, region_shape=spec.region_shape,
        stride=spec.strides, copies=spec.copies, quant=quant,
    )


def _cuda_fused_route(shape, spec: GLCMSpec, kind: int) -> dict:
    if spec.region != "global":  # region_compute: the window kernel, no route
        return {}
    offsets = spec.offsets()
    tile_h = spec.tile_h if spec.tile_h is not None else kops.default_tile_h(offsets)
    plan = launch_plan("glcm_fused", shape, offsets, levels=spec.levels, split=tile_h,
                       copies=spec.copies, kind=kind)
    hist = "cluster" if plan["cluster"] else "shared" if plan["shared_hist"] else "global"
    return {"hist": hist, "copies": plan["copies"], "cluster": plan["cluster"]}


def _cuda_volume_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return kops.glcm_cuda_volume(
        img, spec.levels, spec.pairs, offsets=spec.offsets(), slab_d=spec.slab_d,
        copies=spec.copies, quant=quant,
    )


def _cuda_volume_local_partial(ext, levels, offset, local_n) -> torch.Tensor:
    # One launch over the whole extended slab, as _cuda_fused_local_partial.
    offsets = (tuple(offset),)
    return glcm_volume(ext, levels=levels, offsets=offsets,
                       slab_d=kops.default_slab_d(offsets))[..., 0, :, :]


def _native_quant(quant):
    """(lo, span) as NumPy for ``native.quantize_stack``."""
    if quant is None:
        return None
    return tuple(q.cpu().numpy() if torch.is_tensor(q) else q for q in quant)


def _native_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    # The registry contract for the host-native backend (the temporal
    # delta and the region fallback come through here): NumPy counts of
    # the stack, back on its device as int32. A batch plan calls host_fn
    # directly instead. The round trip is the analyzer's "host" scope.
    with scope("host"):
        q = _native.quantize_stack(img.cpu().numpy(), spec, _native_quant(quant))
        counts = _native.counts_pairs(q, spec.levels, spec.offsets())
        return torch.from_numpy(counts.astype(np.int32)).to(img.device)


def _cuda_volume_validate(spec: GLCMSpec, shape: tuple[int, ...]) -> None:
    if spec.ndim != 3:
        raise ValueError(
            'scheme "cuda_volume" serves only ndim=3 volume specs; use '
            '"cuda"/"cuda_fused" for 2-D images'
        )


register(
    Backend(
        name="scatter",
        compute=_scatter_compute,
        caps=Capabilities(volumetric=True, fused_quantize=True),
    )
)
register(
    Backend(
        name="onehot",
        compute=_onehot_compute,
        caps=Capabilities(
            multi_offset_fused=True, region_grid=True, volumetric=True,
            fused_quantize=True, sharded_partial=True,
        ),
        local_partial=local_partial_nd,
        region_compute=_onehot_region_compute,
    )
)
register(
    Backend(
        name="blocked",
        compute=_blocked_compute,
        caps=Capabilities(volumetric=True),
        validate=_blocked_validate,
    )
)
register(
    Backend(
        name="native",
        compute=_native_compute,
        caps=Capabilities(
            multi_offset_fused=True, volumetric=True, fused_quantize=True,
            host_native=True,
        ),
        host_fn=_native.native_counts,
    )
)
register(
    Backend(
        name="cuda",
        compute=_cuda_compute,
        caps=Capabilities(batch_grid=True, volumetric=True, fused_quantize=True,
                          device_kernel=True),
    )
)
register(
    Backend(
        name="cuda_fused",
        compute=_cuda_fused_compute,
        caps=Capabilities(
            multi_offset_fused=True, batch_grid=True, region_grid=True,
            fused_quantize=True, device_kernel=True, sharded_partial=True,
        ),
        local_partial=_cuda_fused_local_partial,
        region_compute=_cuda_fused_region_compute,
        route=_cuda_fused_route,
    )
)
register(
    Backend(
        name="cuda_volume",
        compute=_cuda_volume_compute,
        caps=Capabilities(
            multi_offset_fused=True, batch_grid=True, volumetric=True,
            volume_only=True, fused_quantize=True, device_kernel=True,
            sharded_partial=True,
        ),
        local_partial=_cuda_volume_local_partial,
        validate=_cuda_volume_validate,
    )
)
