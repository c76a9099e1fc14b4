"""The scheme registry — every GLCM execution strategy behind ONE contract.

Counterpart of ``repro.core.backends``. Each backend implements

    compute(img_batch, spec, quant=None) -> (B, n_pairs, L, L) counts

where ``img_batch`` is an int32 stack of levels — (B, H, W), or (B, D, H, W)
for ``spec.ndim == 3`` — and ``spec`` is resolved (no "auto"). With
``quant=(lo, span)`` (python floats, or per-image (B,) tensors) the stack
holds RAW pixels that the backend bins where it consumes them
(``caps.fused_quantize``); no quantized full-size image is made. Counts come
back as float32. Quantization ranges, symmetric/normalize and features are
the plan's job (``core.plan``).

Built-in strategies:

  "scatter"     paper Scheme 1: one masked ``bincount`` (CPU or card)
  "onehot"      paper Scheme 2: one-hot matmul ``RᵀA`` per copy (CPU)
  "cuda"        pair-stream CUDA vote kernel (``kernels.glcm_vote``)
  "cuda_fused"  fused multi-offset CUDA kernel (``kernels.glcm_fused``)

"auto" resolves per device: on CUDA ``cuda_fused`` for more than one pair,
else ``cuda``; on the CPU ``onehot``. The CUDA backends run on a CPU tensor
too — through their kernels' plain versions — which is how the CPU tests
reach their plumbing.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.core.schemes import glcm_multi, glcm_scatter_batch
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels import ops as kops

__all__ = [
    "Backend",
    "Capabilities",
    "available_backends",
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
    volumetric: bool = False          # serves ndim=3 (D, H, W) volume specs
    fused_quantize: bool = False      # accepts raw pixels + quant=(lo, span)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered execution strategy."""

    name: str
    compute: Callable[..., torch.Tensor]
    caps: Capabilities = Capabilities()


def supports_ndim(backend: Backend, ndim: int) -> bool:
    """Whether ``backend`` can serve specs of spatial rank ``ndim``."""
    return ndim == 2 or backend.caps.volumetric


_REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Add ``backend`` to the registry; its name becomes a scheme name."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} is already registered")
    if backend.name == "auto":
        raise ValueError('"auto" is reserved for scheme resolution')
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

    "auto" picks, on CUDA, the fused kernel when the spec has more than one
    pair and the pair-stream kernel otherwise (the reference's TPU rule);
    on the CPU the one-hot scheme. ``require`` names :class:`Capabilities`
    fields the backend must declare; "auto" then picks the first capable
    backend by name.
    """
    if spec.scheme != "auto":
        get_backend(spec.scheme)  # existence check; capability check in plan
        return spec.scheme
    if require:
        for name in available_backends():
            backend = _REGISTRY[name]
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
            raise NotImplementedError(
                'scheme="auto" for ndim=3 volumes on CUDA needs the depth-slab '
                "volume kernel, which comes with the volume slice of the port; "
                'name scheme="cuda" or "scatter" meanwhile'
            )
        return "cuda_fused" if spec.n_pairs > 1 else "cuda"
    return "onehot"


# ---------------------------------------------------------------------------
# The four built-in strategies
# ---------------------------------------------------------------------------


def _scatter_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return glcm_scatter_batch(img, spec.levels, spec.offsets(), quant=quant).to(torch.float32)


def _onehot_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return glcm_multi(
        img, spec.levels, offsets=spec.offsets(), copies=spec.copies, quant=quant
    )


def _cuda_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    chunk = spec.chunk if spec.chunk is not None else kops.DEFAULT_CHUNK
    # int32 counts widen to float32 here, as the reference backends widen
    # theirs; a cell above 2**24 rounds to the nearest float32.
    return torch.stack(
        [
            kops.glcm_cuda(
                img, spec.levels, offset=off, chunk=chunk,
                copies=max(spec.copies, 1), quant=quant,
            ).to(torch.float32)
            for off in spec.offsets()
        ],
        dim=-3,
    )


def _cuda_fused_compute(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    return kops.glcm_cuda_multi(
        img, spec.levels, spec.pairs, tile_h=spec.tile_h, copies=spec.copies,
        quant=quant,
    ).to(torch.float32)


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
        caps=Capabilities(multi_offset_fused=True, volumetric=True, fused_quantize=True),
    )
)
register(
    Backend(
        name="cuda",
        compute=_cuda_compute,
        caps=Capabilities(batch_grid=True, volumetric=True, fused_quantize=True),
    )
)
register(
    Backend(
        name="cuda_fused",
        compute=_cuda_fused_compute,
        caps=Capabilities(multi_offset_fused=True, batch_grid=True, fused_quantize=True),
    )
)
