"""compile_plan — spec + input shape + device → ONE cached plan.

Counterpart of ``repro.core.plan``:

    spec  = GLCMSpec(levels=32, pairs=PAPER_PAIRS, scheme="auto")
    plan  = compile_plan(spec, imgs.shape)          # resolved, cached
    mats  = plan(imgs)                              # (B, n_pairs, L, L)

Region specs (``region="tiles" | "window"``) give one GLCM per region:
(B, *grid, n_pairs, L, L), with ``plan.grid`` the region grid, validated
against the input shape when the plan is compiled.

``compile_plan`` resolves "auto" (see below), validates the spec against
the concrete shape, builds the program (quantize → backend vote counting →
symmetric/normalize → optionally Haralick features) and caches the
:class:`GLCMPlan` in a bounded LRU keyed by ``(spec, shape, features,
require, device, tuned, temporal_window)``. PyTorch runs eagerly, so a plan
is a Python callable, not a compiled program; the cache still saves the
resolution and validation, and the stats fields match the reference's.

"auto" consults the autotuner's store first (:mod:`repro_torch.core.autotune`):
a winner measured for this spec (knobs reset), shape, requirements and
device class becomes the plan's backend and knobs (``chunk``, ``copies``,
``tile_h``, ``slab_d``, ``num_blocks``), recorded in ``plan.tuned``.
Without one, the registry's rule for the device decides
(``backends.resolve_scheme``). The tuned choice is part of the cache key:
a stored winner hits one cached plan, and a re-tune misses to a fresh one.
Temporal plans consult the store by frame shape. A named scheme never
consults it.

Devices: ``device=None`` means the current CUDA device. Only an explicit
``device="cpu"`` runs on the CPU; asking for CUDA on a machine without a
card raises RuntimeError rather than carrying on elsewhere. The plan moves
its input to its device and returns tensors there: exact int32 counts when
it neither normalizes nor computes features (the reference returns float32,
which rounds a cell past 2²⁴), else float32.

Quantization placement: for ``quantize="uniform"`` on a backend declaring
``caps.fused_quantize`` (all four built-ins) the plan does not quantize. It
derives each image's (lo, span) — python floats when ``spec.vrange`` pins
the range, per-image (B,) reductions otherwise — and hands the RAW stack to
the backend, which bins values where it consumes them (the fused kernel in
registers). The provably-identity case (uint8, ``levels=256``, vrange
(0, 255)) is a plain cast. "equalized" quantizes each image first.

``temporal_window=w`` compiles an incremental temporal plan instead: the
shape is one frame's (no batch axis) and the result is a
:class:`~repro_torch.core.stream_state.GLCMStreamPlan` with ``init_state()``
/ ``update(state, frame)`` / ``rolling(video)``, cached apart from batch
plans. Its per-frame delta is this plan's own quantize→vote path on a unit
batch: the backend's int32 counts as they are.

A ``caps.host_native`` backend ("native", picked only by name) counts on the
host with NumPy; the symmetric/normalize/features tail then runs on the
plan's device.

Observability, as in the reference: every lookup counts into
``repro_plan_cache_lookups_total{result=hit|miss}`` of the port's metrics
registry (:mod:`repro_torch.obs.metrics`); a miss observes the plan's build
time in ``repro_plan_compile_ms`` and, with a live tracer, records a
``plan.compile`` span; a hit records a ``plan.cache_hit`` event. Batch and
temporal plans alike. Beyond the reference, each call of a batch plan
records, with the global tracer live at call time (:func:`~repro_torch.obs.
trace.get_tracer`), a ``plan.run`` span (``batch``, ``scheme``) with three
children in order: ``plan.prepare`` (the range reduction, quantization or
cast), ``plan.count`` (the backend's count; on a host-native backend also
the copy of the counts to the device; on the device path ``hist`` and
``copies``, the count's route by ``backends.count_route``, found at the
plan's first traced call and kept with the plan) and ``plan.tail``
(symmetric, normalize, Haralick features; ``matrices``, and ``solver``: a
plan with features hands its int32 counts to the tail through
``core.haralick.haralick_features``, "kernel" where its kernel runs on the
card, else "plain"; fixed when the plan is compiled), inside which f14's
eigensolver records ``haralick.eigvalsh`` (``matrices``, ``solver``:
"kernel" where the card's kernel solves it, else "eigvalsh"; ``chunks``,
the eigvalsh calls, 0 on the kernel). They are host times: no span
synchronizes the device, so on the card a span ends once its work is
enqueued, or when one of its own ops waited for the device, as eigvalsh
does (f14's kernel launch waits for nothing). Under
``torch.profiler`` each is also a profiler range. Off, each costs the
tracer's shared no-op. ``bucket_sizes`` / ``pick_bucket`` give a batched
server's launch stack sizes.

``check="lint"`` (or ``REPRO_PLAN_LINT=1``) runs the plan-contract
analyzer (:mod:`repro_torch.analysis`) on the plan: one recorded call of it
on a seeded input, on its own device, linted against the rules its backend's
capabilities and its spec imply. The verdict is cached on the plan
(``plan.lint``); findings raise ``PlanContractError``. Each lint observes
``repro_plan_lint_ms{scheme}`` and, with a live tracer, records a
``plan.lint`` span. ``spec.batch_mode`` is accepted and ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.analysis.scopes import scope
from repro_torch.core import backends as _backends
from repro_torch.core import native as _native
from repro_torch.core.haralick import FEATURE_NAMES, haralick_features
from repro_torch.core.quantize import (
    is_identity_quantize,
    quantize_equalized,
    quantize_uniform,
    uniform_params,
)
from repro_torch.core.spec import GLCMSpec
from repro_torch.core.stream_state import GLCMStreamPlan
from repro_torch.kernels import tail_kernel as _tail
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "GLCMPlan",
    "GLCMStreamPlan",
    "bucket_sizes",
    "compile_plan",
    "pick_bucket",
    "plan_cache_clear",
    "plan_cache_limit",
    "plan_cache_stats",
    "resolve_device",
]


@dataclasses.dataclass(frozen=True)
class GLCMPlan:
    """A resolved GLCM program for one input shape on one device.

    ``spec`` is resolved (``spec.scheme`` names a registered backend, never
    "auto"). ``grid`` is the region grid: () for "global", else (gh, gw) or
    (gd, gh, gw). Calling the plan maps (*spatial) → (*grid, n_pairs, L, L)
    or (B, *spatial) → (B, *grid, n_pairs, L, L) on ``device``: int32
    counts, or float32 with ``spec.normalize``; with ``features`` the
    trailing (L, L) becomes the selected Haralick features (float32).
    """

    spec: GLCMSpec
    backend: _backends.Backend
    shape: tuple[int, ...]
    features: bool | tuple[str, ...]
    device: torch.device
    fn: Callable[[torch.Tensor], torch.Tensor]
    grid: tuple[int, ...] = ()
    fused_quantize: bool = False   # quantization is binned inside the count
    host_native: bool = False      # counts with NumPy on the host
    tuned: object = None           # the autotune.TunedChoice applied, if any
    lint: tuple | None = None      # the lint verdict (Findings), once linted

    def __call__(self, img) -> torch.Tensor:
        return self.fn(img)


_DEFAULT_CACHE_LIMIT = 128
_CACHE: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_LIMIT = [_DEFAULT_CACHE_LIMIT]


def plan_cache_clear() -> None:
    """Drop every cached plan and zero the counters."""
    with _LOCK:
        _CACHE.clear()
        _STATS["hits"] = _STATS["misses"] = _STATS["evictions"] = 0


def plan_cache_limit(limit: int | None = None) -> int:
    """Get (no argument) or set the LRU bound on cached plans (>= 1,
    default 128). A smaller bound evicts least-recently-used plans now."""
    with _LOCK:
        if limit is not None:
            if limit < 1:
                raise ValueError(f"plan cache limit must be >= 1, got {limit}")
            _LIMIT[0] = int(limit)
            while len(_CACHE) > _LIMIT[0]:
                _CACHE.popitem(last=False)
                _STATS["evictions"] += 1
        return _LIMIT[0]


def plan_cache_stats() -> dict:
    """{'hits', 'misses', 'evictions', 'hit_rate', 'size', 'limit'} of the
    plan cache (counters monotonic until clear; ``hit_rate`` is
    hits / (hits + misses), 0.0 before any lookup)."""
    with _LOCK:
        lookups = _STATS["hits"] + _STATS["misses"]
        hit_rate = _STATS["hits"] / lookups if lookups else 0.0
        return {
            **_STATS, "hit_rate": hit_rate, "size": len(_CACHE),
            "limit": _LIMIT[0],
        }


def bucket_sizes(
    max_batch: int, buckets: tuple[int, ...] | None = None
) -> tuple[int, ...]:
    """The ascending launch stack sizes a batched server pre-declares.

    ``None`` → the powers of two up to ``max_batch`` plus ``max_batch``
    itself (8 → (1, 2, 4, 8); 6 → (1, 2, 4, 6)), so a partial dispatch of
    k requests pads at most k-1 slots while only O(log max_batch) plan
    shapes are ever built. An explicit tuple is validated: positive,
    strictly ascending, ending at ``max_batch``.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if buckets is None:
        sizes = []
        b = 1
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(max_batch)
        return tuple(sizes)
    sizes = tuple(int(b) for b in buckets)
    if not sizes or any(b < 1 for b in sizes):
        raise ValueError(f"buckets must be positive, got {buckets!r}")
    if any(a >= b for a, b in zip(sizes, sizes[1:])):
        raise ValueError(f"buckets must be strictly ascending, got {buckets!r}")
    if sizes[-1] != max_batch:
        raise ValueError(
            f"buckets must end at the batch size {max_batch}, got {buckets!r}")
    return sizes


def pick_bucket(buckets: tuple[int, ...], n: int) -> int:
    """The smallest pre-declared bucket that fits ``n`` requests."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} requests exceed the largest bucket {buckets[-1]}")


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises RuntimeError when CUDA is
    asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: repro_torch runs on the card unless "
                "the caller passes device='cpu'"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def _canonical_features(features) -> bool | tuple[str, ...]:
    """Validate/canonicalize the ``features`` argument (bool or name tuple)."""
    if isinstance(features, bool):
        return features
    names = tuple(features)
    for name in names:
        if name not in FEATURE_NAMES:
            raise ValueError(
                f"unknown Haralick feature {name!r}; expected names from "
                f"{FEATURE_NAMES}"
            )
    if not names:
        raise ValueError("features=() selects nothing; pass False instead")
    return names


def _quantizer(spec: GLCMSpec) -> Callable[[torch.Tensor], torch.Tensor] | None:
    """Per-image quantizer for plans that quantize before counting."""
    if spec.quantize is None:
        return None
    if spec.quantize == "uniform":
        vmin, vmax = spec.vrange if spec.vrange is not None else (None, None)
        return lambda im: quantize_uniform(im, spec.levels, vmin=vmin, vmax=vmax)
    return lambda im: quantize_equalized(im, spec.levels)


def _lint_enabled_by_env() -> bool:
    return os.environ.get("REPRO_PLAN_LINT", "").lower() in ("1", "true", "yes")


def _cache_put(key, plan):
    """Insert ``plan`` under ``key`` (first writer wins), enforce the LRU
    bound, and return the cached instance."""
    with _LOCK:
        plan = _CACHE.setdefault(key, plan)
        _CACHE.move_to_end(key)
        _STATS["misses"] += 1
        while len(_CACHE) > _LIMIT[0]:
            _CACHE.popitem(last=False)
            _STATS["evictions"] += 1
    return plan


def _note_compile(resolved: GLCMSpec, shape, kind: str, t_build: float,
                  t_build_tr: float) -> None:
    """Record one plan-cache miss: miss counter, build-ms histogram, and
    (tracing on) a ``plan.compile`` span."""
    ms = (time.perf_counter() - t_build) * 1e3
    reg = _obs_metrics.get_registry()
    reg.counter("repro_plan_cache_lookups_total",
                "plan-cache lookups by result", result="miss").inc()
    reg.histogram("repro_plan_compile_ms",
                  "plan build time on cache miss (ms)",
                  scheme=resolved.scheme).observe(ms)
    tr = _obs_trace.get_tracer()
    if tr.enabled:
        tr.add_span("plan.compile", t_build_tr, tr.clock(),
                    scheme=resolved.scheme, shape=str(tuple(shape)),
                    kind=kind, ms=round(ms, 3))


def _ensure_linted(plan):
    """Lint ``plan`` once, cache the verdict on the entry, raise on findings.

    The verdict rides the cached plan (``plan.lint``), not the cache key: a
    plan compiled without ``check`` and later requested with
    ``check="lint"`` is linted on that hit, and every later linted lookup
    replays the stored verdict without running the plan.
    """
    from repro_torch.analysis import op_lint  # late: the analyzer imports plan

    if plan.lint is None:
        tr = _obs_trace.get_tracer()
        t_tr = tr.clock() if tr.enabled else 0.0
        t0 = time.perf_counter()
        findings = tuple(op_lint.lint_plan(plan))
        lint_ms = (time.perf_counter() - t0) * 1e3
        _obs_metrics.get_registry().histogram(
            "repro_plan_lint_ms", "plan-contract lint time (ms)",
            scheme=plan.spec.scheme).observe(lint_ms)
        if tr.enabled:
            tr.add_span("plan.lint", t_tr, tr.clock(), scheme=plan.spec.scheme,
                        findings=len(findings), ms=round(lint_ms, 3))
        object.__setattr__(plan, "lint", findings)
    if plan.lint:
        raise op_lint.PlanContractError(plan.lint)
    return plan


def compile_plan(
    spec: GLCMSpec,
    shape: tuple[int, ...],
    *,
    features: bool | tuple[str, ...] = False,
    require: tuple[str, ...] = (),
    device=None,
    check: str | None = None,
    temporal_window: int | None = None,
) -> GLCMPlan:
    """Resolve ``spec`` for input ``shape`` on ``device`` and return the
    cached GLCMPlan.

    ``shape`` is (H, W) or (B, H, W) for 2-D specs, (D, H, W) or
    (B, D, H, W) for ``spec.ndim == 3``. ``features=True`` appends the
    Haralick-14 stage; a tuple of names selects a subset in that order
    (skipping the eigendecomposition when ``max_correlation_coefficient`` is
    not asked for). ``require`` names capability fields the backend must
    declare. ``device=None`` means CUDA (see :func:`resolve_device`).

    ``temporal_window=w`` compiles an incremental temporal plan: ``shape``
    is then the per-frame spatial shape (no batch axis; one plan per
    stream) and the result is a :class:`GLCMStreamPlan`. Expiry subtracts
    the ring-buffered delta of the frame leaving the ``w``-frame window, and
    symmetric/normalize/Haralick apply lazily on the accumulated signed
    int32 counts, bit-exact against a full recompute of the window.

    ``check="lint"`` also lints the plan (:mod:`repro_torch.analysis`): it
    runs the plan once on a seeded input of its shape, records the aten ops,
    scopes and kernel launches of that call, and raises
    ``PlanContractError`` on any finding. The verdict is cached on the plan
    entry, so later linted lookups cost nothing. ``REPRO_PLAN_LINT=1`` turns
    the check on for every call that does not pass ``check``; ``check=""``
    opts one call back out.
    """
    if check is None and _lint_enabled_by_env():
        check = "lint"
    if check not in (None, "", "lint"):
        raise ValueError(f"unknown check mode {check!r}; expected 'lint'")
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    nd = spec.ndim
    if temporal_window is not None:
        if not isinstance(temporal_window, int) or temporal_window < 1:
            raise ValueError(
                f"temporal_window must be a positive int or None, got {temporal_window!r}"
            )
        if len(shape) != nd:
            raise ValueError(
                f"temporal plans stream unbatched frames: expected a "
                f"{'(H, W)' if nd == 2 else '(D, H, W)'} frame shape for an "
                f"ndim={nd} spec, got {shape} (the time axis is the stream, "
                f"not a shape dimension)"
            )
    if len(shape) not in (nd, nd + 1):
        expect = ("(H, W) or (B, H, W)" if nd == 2
                  else "(D, H, W) or (B, D, H, W)")
        raise ValueError(
            f"expected a {expect} shape for an ndim={nd} spec, got {shape}"
        )
    require = tuple(require)
    features = _canonical_features(features)
    tuned = None
    if spec.scheme == "auto":
        from repro_torch.core import autotune as _autotune  # late: plan ↔ autotune

        tuned = _autotune.lookup(spec, shape, require=require, device=device)
    # The tuned choice is part of the key: a stored winner hits the same
    # cached plan every time, while a newly recorded winner misses to a
    # fresh plan instead of serving the stale one.
    key = (spec, shape, features, require, device, tuned, temporal_window)
    with _LOCK:
        plan = _CACHE.get(key)
        if plan is not None:
            _CACHE.move_to_end(key)
            _STATS["hits"] += 1
    tracer = _obs_trace.get_tracer()
    if plan is not None:
        _obs_metrics.get_registry().counter(
            "repro_plan_cache_lookups_total", "plan-cache lookups by result",
            result="hit").inc()
        if tracer.enabled:
            tracer.event("plan.cache_hit", scheme=plan.spec.scheme, shape=str(shape))
        return _ensure_linted(plan) if check == "lint" else plan

    # Cache miss: time the plan build (backend resolution, validation and
    # the program's closures) for the compile span and histogram.
    t_build_tr = tracer.clock() if tracer.enabled else 0.0
    t_build = time.perf_counter()
    if tuned is not None:
        name = tuned.backend
    else:
        name = _backends.resolve_scheme(spec, device, require=require)
    backend = _backends.get_backend(name)
    if not _backends.supports_ndim(backend, nd):
        raise ValueError(
            f"scheme {name!r} lacks required capability 'volumetric' "
            f"(cannot serve ndim={nd} specs)"
            if nd == 3
            else f"scheme {name!r} serves only ndim=3 volume specs"
        )
    for cap in require:
        if not getattr(backend.caps, cap):
            raise ValueError(f"scheme {name!r} lacks required capability {cap!r}")
    if tuned is not None:
        resolved = tuned.apply(spec)
    else:
        resolved = spec if spec.scheme == name else spec.replace(scheme=name)

    spatial = shape[-nd:]
    # Regions are validated against the concrete shape before any work
    # (tiles must divide the input, windows must fit)...
    grid = resolved.region_grid(*spatial)
    if grid:
        # ...and the backend sees regions, never the whole input, so its own
        # validation runs on the per-region batch it will serve. Offsets were
        # checked against the region when the spec was built.
        n_regions = math.prod(grid) * (shape[0] if len(shape) == nd + 1 else 1)
        backend_shape: tuple[int, ...] = (n_regions,) + resolved.region_shape
    else:
        # The leading spatial delta is non-negative by construction; the
        # rest may be negative (3-D inter-slice directions).
        for (d, t), off in zip(resolved.pairs, resolved.offsets()):
            if off[0] >= spatial[0] or any(
                abs(o) >= s for o, s in zip(off[1:], spatial[1:])
            ):
                raise ValueError(
                    f"offset (d={d}, {t}) → {off} exceeds input shape {spatial}"
                )
        backend_shape = shape
    if backend.validate is not None:
        backend.validate(resolved, backend_shape)

    quant = _quantizer(resolved)
    batched = len(shape) == nd + 1
    select = None if isinstance(features, bool) else features
    fused = resolved.quantize == "uniform" and backend.caps.fused_quantize
    vmin, vmax = resolved.vrange if resolved.vrange is not None else (None, None)

    # The features take the int32 counts straight to the tail; its route
    # ("kernel" or "plain") is the ``solver`` of the ``plan.tail`` span.
    solver = _tail.route(device.type, resolved.levels).tail if features else "plain"

    def tail(mats: torch.Tensor) -> torch.Tensor:
        if resolved.symmetric:
            mats = mats + mats.transpose(-1, -2)
        if features:
            with scope("tail"):  # float64 inside, by design (core.haralick)
                return haralick_features(mats, select=select,
                                         float32_step=resolved.normalize)
        if resolved.normalize:
            mats = mats.to(torch.float32)   # counts stay int32 until they divide
            mats = mats / mats.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)
        return mats

    def prepare(stack: torch.Tensor):
        """(B, *spatial) on the device → what the backend counts: the RAW
        stack plus per-image (lo, span) when quantization is fused (no
        quantized image), else int32 levels."""
        if fused:
            if is_identity_quantize(stack.dtype, resolved.levels, vmin, vmax):
                # The input already holds the levels: a cast, no binning.
                return stack.to(torch.int32), None
            return stack, uniform_params(stack, vmin=vmin, vmax=vmax, batched=True)
        if quant is not None:
            # Each image of a batch is quantized with its own range;
            # regions share their image's range, never one of their own.
            stack = torch.stack([quant(im) for im in stack])
        return stack.to(torch.int32), None

    def as_input(img) -> torch.Tensor:
        x = torch.as_tensor(img, device=device)
        if tuple(x.shape) != shape:
            raise ValueError(f"plan compiled for shape {shape}, got {tuple(x.shape)}")
        return x

    if temporal_window is not None:
        # The per-frame vote delta is this plan's own quantize→vote path on
        # a unit batch: the backend's exact int32 counts, which the signed
        # rolling state adds and, on expiry, subtracts.
        def delta_fn(frame: torch.Tensor) -> torch.Tensor:
            stack, qargs = prepare(frame[None])
            return _backends.compute_regions(backend, stack, resolved, quant=qargs)[0]

        plan = GLCMStreamPlan(
            spec=resolved, backend=backend, shape=shape, window=temporal_window,
            features=features, delta_fn=delta_fn, tail_fn=tail, device=device, grid=grid,
            fused_quantize=fused, host_native=backend.caps.host_native, tuned=tuned,
        )
        _note_compile(resolved, shape, "stream", t_build, t_build_tr)
        plan = _cache_put(key, plan)
        return _ensure_linted(plan) if check == "lint" else plan

    n_batch = shape[0] if batched else 1
    n_mats = n_batch * math.prod(grid) * len(resolved.pairs)  # the tail's matrices
    routes: dict = {}  # the count's route, by what the backend is handed

    def route(stack: torch.Tensor, qargs) -> dict:
        key = (stack.dtype, qargs is None)
        if key not in routes:
            routes[key] = _backends.count_route(backend, stack, resolved, quant=qargs)
        return routes[key]

    def run(img) -> torch.Tensor:
        tr = _obs_trace.get_tracer()
        with tr.span("plan.run", batch=n_batch, scheme=resolved.scheme):
            x = as_input(img)
            with tr.span("plan.prepare"):
                stack, qargs = prepare(x if batched else x[None])
            with tr.span("plan.count", **(route(stack, qargs) if tr.enabled else {})):
                counts = _backends.compute_regions(backend, stack, resolved, quant=qargs)
            with tr.span("plan.tail", matrices=n_mats, solver=solver):
                mats = tail(counts)
        return mats if batched else mats[0]

    def run_host(img) -> torch.Tensor:
        # NumPy counts on the host, the analyzer's "host" scope; only the
        # tail runs on the plan's device.
        tr = _obs_trace.get_tracer()
        with tr.span("plan.run", batch=n_batch, scheme=resolved.scheme):
            with scope("host"):
                x = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
                if tuple(x.shape) != shape:
                    raise ValueError(f"plan compiled for shape {shape}, got {tuple(x.shape)}")
                with tr.span("plan.prepare"):
                    stack = x if batched else x[None]
                    qargs = None
                    if fused:
                        identity = x.dtype == np.uint8 and is_identity_quantize(
                            torch.uint8, resolved.levels, vmin, vmax)
                        if not identity:  # else the values already are the levels
                            qargs = _native.uniform_params_np(stack, vmin, vmax)
                    elif quant is not None:
                        stack = torch.stack([quant(im) for im in torch.from_numpy(stack)]).numpy()
                with tr.span("plan.count"):
                    counts = backend.host_fn(stack, resolved, qargs)
                    mats = torch.from_numpy(np.asarray(counts, np.int32)).to(device)
            with tr.span("plan.tail", matrices=n_mats, solver=solver):
                mats = tail(mats)
        return mats if batched else mats[0]

    host = backend.caps.host_native
    plan = GLCMPlan(
        spec=resolved, backend=backend, shape=shape, features=features,
        device=device, fn=run_host if host else run, grid=grid, fused_quantize=fused,
        host_native=host, tuned=tuned,
    )
    _note_compile(resolved, shape, "plan", t_build, t_build_tr)
    plan = _cache_put(key, plan)
    return _ensure_linted(plan) if check == "lint" else plan
