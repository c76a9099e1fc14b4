"""Persisted autotuner: make ``scheme="auto"`` mean *measured*, not *default*.

Counterpart of ``repro.core.autotune``. The paper tunes its execution by
hand (R private copies, block shapes: Tables II and III); this module
automates that. :func:`autotune` measures every eligible backend of the
registry over a small knob grid for one concrete ``(spec, shape)`` workload
on one device, records the winner, and ``compile_plan`` consults the store
whenever it resolves ``scheme="auto"``.

Search space (per backend), all spec fields, so a winner is a partial spec
update:

  "cuda"         ``chunk`` x ``copies`` (the vote kernel's pair-stream slice
                 and the paper's R; the kernel clamps R to what fits in
                 shared memory)
  "cuda_fused"   ``tile_h`` x ``copies`` (the marching kernel's row tile);
                 region specs: ``copies`` of the window kernel
  "cuda_volume"  ``slab_d`` x ``copies``
  "onehot"       ``copies``
  "blocked"      ``num_blocks`` (those that divide the leading extent)
  "scatter", "native"  no knobs

Every grid holds the backend's default knobs (``None`` is the kernel's own
default), so the winner is never a setting that the untuned choice beat in
the same run. The reference's ``batch_mode="unroll"`` candidates are not
measured: the CUDA kernels always carry the batch on their grid and no
backend reads ``batch_mode``; :func:`lookup` still accepts a stored one.

Eligibility: the backends that declare ``caps.device_kernel`` ("cuda",
"cuda_fused", "cuda_volume") are candidates only for a CUDA plan, since on a
CPU tensor they compute their kernels' plain versions. "native" (NumPy on
the host) competes everywhere, as in the reference. The reference keeps
batched "scatter" out of the search on the CPU because XLA-CPU's scatter-add
is sublinear in the batch; this package's scatter is one ``bincount``, whose
images/s grow with the batch on the CPU (3x from B = 1 to B = 8 at 128²), so
it competes at every batch.

Timing: on a CUDA plan each call is bracketed by CUDA events on the current
stream and synchronized. The start event is recorded before the plan's host
work, so host dispatch and the native backend's host counting stay inside
the window. On a CPU plan, ``time.perf_counter``. Two warm-up calls (the
first may build a kernel library with nvcc), then the median of ``trials``.
A candidate that cannot serve the workload (``ValueError``, ``TypeError``,
``NotImplementedError``) or that exhausts the card's memory
(``torch.cuda.OutOfMemoryError``: the plain candidates' one-hot matrices at
the paper's sizes) is recorded as skipped; any other exception propagates,
so a kernel launch failure is never taken for a lost candidate.

Persistence is two-layer, as in the reference: a process-local dict
consulted on every ``compile_plan`` (no I/O on the hot path), loaded once
from a JSON sidecar (``store_path()``; ``REPRO_TORCH_AUTOTUNE_PATH``
overrides it) and written back after each run. The sidecar is this
package's own — never the reference's, so the two packages' winners never
collide. A fresh process re-reads it and serves tuned plans without
measuring. The tuned choice is part of ``compile_plan``'s cache key: a
stored winner hits one cached plan, and a re-tune misses to a fresh one.

Keys identify the WORKLOAD on one device class: the spec with every tunable
knob reset, the input shape, the capability requirements and the plan's
device (``"cpu"`` or ``"cuda:" + the card's name``, so that a winner
measured on one card is never applied on another). Entries are re-validated
at lookup (backend still registered and eligible on the device, knobs
known and valid) and ignored, never trusted, when stale.

Tracing and metrics go to the port's registry and tracer under the
reference's names: ``autotune.run`` / ``autotune.candidate`` spans,
``autotune.skipped`` events and the ``repro_autotune_candidate_us``
histogram.

    python -m repro_torch.core.autotune --size 4096x4096 --batch 8 \\
        --pairs 1:0,1:45,4:0,4:45 --quantize uniform
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core import backends as _backends
from repro_torch.core import plan as _plan
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels.ops import default_slab_d, default_tile_h
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "TunedChoice",
    "autotune",
    "autotune_clear",
    "lookup",
    "main",
    "store_path",
    "tune_key",
]

# Spec fields the tuner may set — reset to their defaults in the workload key.
KNOB_DEFAULTS = {
    "scheme": "auto",
    "copies": 1,
    "num_blocks": 4,
    "accum": "auto",
    "tile_h": None,
    "chunk": None,
    "slab_d": None,
    "batch_mode": "auto",
}

# µs-scale bucket ladder for per-candidate runtimes (the reference's).
_US_BUCKETS = (
    50.0, 100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5,
    2.5e5, 1e6, float("inf"),
)

# Exceptions that mean "this candidate cannot serve this workload".
_REJECTIONS = (ValueError, TypeError, NotImplementedError)

_LOCK = threading.Lock()
# path-str → {key: entry}; per path, so a REPRO_TORCH_AUTOTUNE_PATH override
# never bleeds into the default sidecar.
_MEM: dict[str, dict] = {}


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """A tuning winner: the backend to run and the spec knobs to apply.

    Hashable (knobs are a sorted tuple of pairs): ``compile_plan`` folds the
    whole choice into its cache key.
    """

    backend: str
    knobs: tuple[tuple[str, object], ...] = ()

    def apply(self, spec: GLCMSpec) -> GLCMSpec:
        return spec.replace(scheme=self.backend, **dict(self.knobs))


def store_path() -> pathlib.Path:
    """The JSON sidecar's location (``REPRO_TORCH_AUTOTUNE_PATH`` overrides;
    default ``$XDG_CACHE_HOME/repro-glcm-torch/autotune.json``)."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_PATH")
    if env:
        return pathlib.Path(env)
    cache = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return pathlib.Path(cache) / "repro-glcm-torch" / "autotune.json"


def _store() -> dict:
    """The in-memory winner table for the active sidecar (lazy-loaded)."""
    path = store_path()
    key = str(path)
    with _LOCK:
        table = _MEM.get(key)
        if table is None:
            table = {}
            try:
                with open(path) as fh:
                    loaded = json.load(fh)
                if isinstance(loaded, dict):
                    table = loaded
            except (OSError, ValueError):
                pass  # missing or corrupt sidecar → start empty
            _MEM[key] = table
        return table


def _save(table: dict) -> None:
    path = store_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(table, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only host: winners stay process-local


def autotune_clear(*, disk: bool = False) -> None:
    """Forget tuning winners (the active sidecar's in-memory table; with
    ``disk=True`` also delete the sidecar file)."""
    with _LOCK:
        _MEM.pop(str(store_path()), None)
    if disk:
        try:
            os.unlink(store_path())
        except OSError:
            pass


def _device_class(device: torch.device) -> str:
    """"cpu", or "cuda:" + the card's name: winners travel between cards of
    one model, never to another model."""
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def tune_key(
    spec: GLCMSpec,
    shape: tuple[int, ...],
    require: tuple[str, ...] = (),
    *,
    device=None,
) -> str:
    """Canonical workload identity: the spec with every tunable knob reset,
    plus shape, capability requirements and the device class of
    ``device`` (``None`` = the current CUDA device; raises without a card)."""
    base = spec.replace(**KNOB_DEFAULTS)
    ident = {
        "device": _device_class(_plan.resolve_device(device)),
        "spec": repr(base),
        "shape": [int(s) for s in shape],
        "require": sorted(require),
    }
    return json.dumps(ident, sort_keys=True)


def _eligible(backend: _backends.Backend, spec: GLCMSpec, require,
              device: torch.device) -> bool:
    if not _backends.supports_ndim(backend, spec.ndim):
        return False
    if backend.caps.device_kernel and device.type != "cuda":
        return False  # the plain version on a CPU tensor: not a candidate
    return all(getattr(backend.caps, cap, False) for cap in require)


def lookup(
    spec: GLCMSpec,
    shape: tuple[int, ...],
    *,
    require: tuple[str, ...] = (),
    device=None,
) -> TunedChoice | None:
    """The stored winner for this workload on ``device``, or None.

    Entries are re-validated against the live registry and the device: a
    winner recorded for a backend that is gone, incapable or not eligible
    on this device, or with unknown or invalid knobs, is ignored, never
    trusted.
    """
    device = _plan.resolve_device(device)
    entry = _store().get(tune_key(spec, tuple(shape), tuple(require), device=device))
    if not isinstance(entry, dict) or "backend" not in entry:
        return None
    try:
        backend = _backends.get_backend(entry["backend"])
    except (TypeError, ValueError):
        return None
    if not _eligible(backend, spec, require, device):
        return None
    knobs = entry.get("knobs") or {}
    if not isinstance(knobs, dict) or not set(knobs) <= set(KNOB_DEFAULTS):
        return None
    choice = TunedChoice(backend=entry["backend"], knobs=tuple(sorted(knobs.items())))
    try:
        choice.apply(spec)
    except _REJECTIONS:
        return None  # a knob value the spec refuses (e.g. copies=0)
    return choice


def _candidates(spec: GLCMSpec, shape: tuple[int, ...], name: str) -> list[dict]:
    """The knob grid per backend — small on purpose: the expensive axis is
    backend choice; knobs refine the winner. ``None`` is the kernel's own
    default, and each grid holds the backend's default knobs."""
    if name == "onehot":
        return [{"copies": c} for c in (1, 2, 4)]
    if name == "blocked":
        n0 = shape[-spec.ndim] if spec.region == "global" else spec.region_shape[0]
        halo = max(off[0] for off in spec.offsets())
        out = [
            {"num_blocks": nb}
            for nb in (2, 4, 8)
            if n0 % nb == 0 and halo <= n0 // nb
        ]
        return out or [{}]
    if name == "cuda":
        return [{"chunk": c, "copies": r} for c in (None, 1024, 4096) for r in (1, 2, 4)]
    if name == "cuda_fused":
        if spec.region != "global":  # the window kernel has no row tile
            return [{"copies": r} for r in (1, 2, 4)]
        default = default_tile_h(spec.offsets())
        tiles = (None,) + tuple(t for t in (16, 32) if t != default)
        return [{"tile_h": t, "copies": r} for t in tiles for r in (1, 2)]
    if name == "cuda_volume":
        default = default_slab_d(spec.offsets())
        slabs = (None,) + tuple(s for s in (8, 16) if s != default)
        return [{"slab_d": s, "copies": r} for s in slabs for r in (1, 2)]
    return [{}]


def _sample_input(spec: GLCMSpec, shape: tuple[int, ...], device) -> torch.Tensor:
    """The reference's sample: uniform float32 in [0, 255) to quantize, else
    int32 levels in [0, L); made from seed 0 with NumPy, on ``device``."""
    rng = np.random.default_rng(0)
    if spec.quantize is not None:
        x = rng.random(shape, dtype=np.float32) * 255.0
    else:
        x = rng.integers(0, spec.levels, shape, dtype=np.int32)
    return torch.from_numpy(x).to(device)


def _time_plan(plan, x, trials: int) -> float:
    """Median time of ``plan(x)`` in µs after two warm-up calls: CUDA events
    around each call (host work included) on a CUDA plan, the host clock on
    a CPU plan."""
    if plan.device.type == "cuda":
        stream = torch.cuda.current_stream(plan.device)

        def call() -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            plan(x)
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
    else:
        def call() -> float:
            t0 = time.perf_counter()
            plan(x)
            return time.perf_counter() - t0

    call()
    call()
    return statistics.median(call() for _ in range(max(trials, 1))) * 1e6


def autotune(
    spec: GLCMSpec,
    shape: tuple[int, ...],
    *,
    features: bool | tuple[str, ...] = False,
    require: tuple[str, ...] = (),
    trials: int = 3,
    persist: bool = True,
    verbose: bool = False,
    report: dict | None = None,
    device=None,
) -> TunedChoice:
    """Measure every eligible (backend, knobs) candidate for this workload on
    ``device`` (``None`` = the current CUDA device; raises without a card),
    record the winner (in memory always; in the JSON sidecar when
    ``persist``) and return it. Later ``compile_plan(spec_with_auto, shape,
    device=...)`` calls resolve to the winner — in this process and, through
    the sidecar, in every later one.

    Pass ``report={}`` to receive ``report["measured"]``, one
    ``{"backend", "knobs", "us"}`` row per measured candidate, and
    ``report["skipped"]``, one ``{"backend", "knobs", "reason"}`` row per
    candidate that could not serve the workload (a rejection at plan or run
    time, or the card's memory exhausted). Any other exception propagates:
    a crash inside a measurement is a bug, not an ineligible candidate.
    """
    device = _plan.resolve_device(device)
    shape = tuple(int(s) for s in shape)
    require = tuple(require)
    tr = _obs_trace.get_tracer()
    t_run0 = tr.clock() if tr.enabled else 0.0
    hist_us = _obs_metrics.get_registry().histogram
    x = _sample_input(spec, shape, device)
    measured: list[dict] = []
    skipped: list[dict] = []
    for name in _backends.available_backends():
        backend = _backends.get_backend(name)
        if not _eligible(backend, spec, require, device):
            continue
        for knobs in _candidates(spec, shape, name):
            t_cand0 = tr.clock() if tr.enabled else 0.0
            try:
                cand = spec.replace(scheme=name, **knobs)
                p = _plan.compile_plan(cand, shape, features=features, require=require,
                                       device=device)
                us = _time_plan(p, x, trials)
            except (torch.cuda.OutOfMemoryError, *_REJECTIONS) as exc:
                # An expected rejection (invalid knob/shape combination for
                # THIS backend) or a plain candidate too big for the card.
                kind = type(exc).__name__
                reason = f"{kind}: {exc}".splitlines()[0]
                us = None
            if us is None:
                if kind == "OutOfMemoryError":
                    torch.cuda.empty_cache()  # the failed call's tensors are gone now
                skipped.append({"backend": name, "knobs": dict(knobs), "reason": reason})
                if tr.enabled:
                    tr.event("autotune.skipped", backend=name, knobs=str(dict(knobs)),
                             reason=kind)
                if verbose:
                    print(f"  {name} {knobs}: skipped ({reason})")
                continue
            hist_us("repro_autotune_candidate_us",
                    "per-candidate median plan runtime (us)",
                    buckets=_US_BUCKETS, backend=name).observe(us)
            if tr.enabled:
                tr.add_span("autotune.candidate", t_cand0, tr.clock(), backend=name,
                            knobs=str(dict(knobs)), us=round(us, 1))
            if verbose:
                print(f"  {name} {knobs}: {us:.0f} us")
            measured.append({"backend": name, "knobs": dict(knobs), "us": us})
    if report is not None:
        report["measured"] = measured
        report["skipped"] = skipped
    if not measured:
        raise RuntimeError(
            f"no eligible backend could serve spec {spec} at shape {shape} on "
            f"{device}; {len(skipped)} candidate(s) were rejected: {skipped}"
        )
    best = min(measured, key=lambda row: row["us"])
    name, knobs, us = best["backend"], best["knobs"], best["us"]
    key = tune_key(spec, shape, require, device=device)
    table = _store()
    with _LOCK:
        table[key] = {"backend": name, "knobs": knobs, "us": round(us, 1)}
        snapshot = dict(table)
    if persist:
        _save(snapshot)
    if tr.enabled:
        tr.add_span("autotune.run", t_run0, tr.clock(), winner=name,
                    knobs=str(dict(knobs)), us=round(us, 1),
                    candidates=len(measured), skipped=len(skipped))
    return TunedChoice(backend=name, knobs=tuple(sorted(knobs.items())))


def _parse_pairs(text: str) -> tuple[tuple[int, int], ...]:
    out = []
    for part in text.split(","):
        d, t = part.split(":")
        out.append((int(d), int(t)))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Tune GLCM execution for one workload on the card and persist "
                    "the winner."
    )
    ap.add_argument("--size", default="512x512", help="spatial shape, e.g. 512x512")
    ap.add_argument("--batch", type=int, default=0, help="batch size (0 = unbatched)")
    ap.add_argument("--levels", type=int, default=32)
    ap.add_argument("--pairs", default="1:0", help="d:theta list, e.g. 1:0,1:45")
    ap.add_argument("--quantize", default=None, choices=[None, "uniform", "equalized"])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)

    spatial = tuple(int(s) for s in args.size.split("x"))
    shape = ((args.batch,) if args.batch else ()) + spatial
    spec = GLCMSpec(
        levels=args.levels,
        pairs=_parse_pairs(args.pairs),
        quantize=args.quantize,
        ndim=len(spatial),
    )
    report: dict = {}
    choice = autotune(
        spec, shape, trials=args.trials, persist=not args.no_persist,
        verbose=True, report=report,
    )
    entry = _store()[tune_key(spec, shape)]
    if report["skipped"]:
        print(f"skipped {len(report['skipped'])} candidate(s):")
        for row in report["skipped"]:
            print(f"  {row['backend']} {row['knobs']}: {row['reason']}")
    print(
        f"winner: {choice.backend} {dict(choice.knobs)} "
        f"({entry['us']:.0f} us) -> {store_path()}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
