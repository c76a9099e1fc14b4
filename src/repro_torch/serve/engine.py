"""Serving engines on the card: LM generation and continuous-batching GLCM
features. Counterpart of ``repro.serve.engine``.

``Engine`` — a small but real LM engine: a batch of prompts is prefilled
once, then decoded token by token (greedy ``argmax`` or temperature
sampling) against the model's caches (full, ring or SSM state), with per-slot
positions and an EOS early stop: the reference's loop, step for step.
Temperature sampling draws Gumbel noise from a ``torch.Generator`` seeded
from ``ServeConfig.seed`` — reproducible by seed, but not the bits of the
reference's ``jax.random.categorical``. ``perplexity`` is exp(mean NLL) of a
token batch.

``GLCMEngine`` runs the paper workload as a service. The paper's 50× comes
from keeping the device saturated with batched work; the engine's job is to
keep launches *full and frequent* under real traffic:

* **Continuous batching with latency deadlines.**  ``submit()`` enqueues a
  request; a full batch still auto-dispatches, but with ``max_wait_ms`` set
  the engine also launches a PARTIAL batch the moment the oldest queued
  request's age reaches the deadline — a lone request is never stranded
  behind an unfilled batch.  ``max_wait_ms=None`` (the default) waits until
  a batch is full.
* **Bucketed launch shapes.**  Partial dispatches are padded up to the
  smallest of a small set of pre-declared stack sizes (default the powers
  of two up to ``batch_size``, e.g. 1/2/4/8) instead of the full batch.
  Bucket plans resolve through the shared bounded-LRU plan cache
  (``core.plan.compile_plan``): engines with equal specs on one device
  share plans. With ``scheme="auto"``, an autotuner winner stored for a
  bucket's shape before the engine compiles that bucket
  (``core.autotune``) is what the engine serves.
* **Many specs, one engine.**  ``register(spec, image_shape)`` adds a
  workload (its own queue, buckets, plans, metrics) multiplexed over the
  same dispatch loop; ``submit(img, workload=wid)`` routes to it.  The
  config's own spec is workload 0.
* **Priorities + backpressure.**  ``submit(..., priority=p)`` biases the
  dequeue order (priority plus queued age, so low-priority requests age
  upward instead of starving; a deadline launch always includes the oldest
  request).  ``max_queue_depth`` bounds each queue — beyond it ``submit``
  sheds the request with :class:`QueueFullError`, counted in ``stats()``.
* **Observability.**  ``stats()`` reports, per workload: queue depth,
  p50/p95/p99 queue/service/end-to-end latency, a per-phase breakdown (pad /
  launch / readback), a batch-occupancy histogram, shed and result-eviction
  counters — plus the plan-cache hit rate.  ``dispatch_log`` keeps the last
  dispatches.  Counters, gauges and latency histograms also stream into the
  port's process-global :mod:`repro_torch.obs.metrics` registry under the
  reference's series names (``repro_serve_*``; Prometheus text via
  ``get_registry().to_prometheus()``).
* **Tracing.**  With a live :class:`repro_torch.obs.trace.Tracer` (inject
  via ``GLCMEngine(..., tracer=...)``, install globally with ``set_tracer``,
  or set ``REPRO_TRACE=1``), every request becomes one span tree under its
  ticket correlation id — ``glcm.request`` → queue_wait / pad / launch /
  readback — plus per-batch ``glcm.dispatch`` spans, exportable as
  Perfetto-loadable Chrome JSON (``tracer.save_chrome``).  Tracing off is a
  single attribute check on the dispatch path.
* **Flight recorder.**  ``engine.flight`` keeps a bounded ring of recent
  dispatch/shed records; on :class:`QueueFullError` or a dispatch exception
  the ring is dumped to ``engine.last_incident`` (and to ``REPRO_FLIGHT_DIR``
  when set) for post-mortem without tracing on.

**The launch boundary is a device sync.**  A dispatch's phases are pad
(stacking the requests on the host), launch (the host→device copy of the
stack, the plan call, then ``torch.cuda.synchronize`` of the plan's device)
and readback (``out.cpu().numpy()``).  PyTorch returns before the card is
done, so without the sync ``launch_ms`` would be the enqueue time and the
kernels would land in ``readback_ms``; with it, the ``glcm.launch`` span's
``synced=True`` holds.

Results live on the host: the bounded result store (``max_results``;
tickets never retrieved evict oldest-first, counted per workload) and
``push()`` hold numpy arrays, never device memory.  A ``temporal_window``
config also serves rolling-window video sessions
(``open_stream``/``push``/``close_stream``) through the incremental temporal
plan of ``core.stream_state``, alongside the batch traffic.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.pipeline import pad_stack
from repro_torch.core.plan import (
    bucket_sizes,
    compile_plan,
    pick_bucket,
    plan_cache_stats,
    resolve_device,
)
from repro_torch.core.spec import GLCMSpec
from repro_torch.core.stream_state import GLCMStreamState
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.recorder import FlightRecorder

__all__ = ["Engine", "GLCMEngine", "GLCMServeConfig", "QueueFullError", "ServeConfig",
           "perplexity"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    eos_id: int | None = None
    s_cache: int = 256
    seed: int = 0


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class Engine:
    """LM generation with ``model`` (the module ``build_model(cfg).init``
    returns, or one loaded with the reference's parameters) on ``device``
    (``None`` = the card; raises without one). The model must already live
    there: the engine copies no weights."""

    def __init__(self, cfg, model: torch.nn.Module, scfg: ServeConfig = ServeConfig(), *,
                 device=None):
        self.cfg = cfg
        self.api = build_model(cfg, device=device)
        self.device = self.api.device
        if _model_device(model) != self.device:
            raise ValueError(f"model parameters live on {_model_device(model)}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.scfg = scfg
        self._prefill = lambda p, b: self.api.prefill(p, b, s_cache=scfg.s_cache)
        self._step = self.api.decode_step

    def generate(self, prompts: np.ndarray, *, enc_embeds: np.ndarray | None = None
                 ) -> np.ndarray:
        """prompts: (B, T) int ids in [0, vocab_size) → (B, T + max_new)
        generated ids. An encoder-decoder config also takes the encoder's
        frame embeddings ``enc_embeds`` (B, T_enc, d_model): the reference
        engine feeds tokens only, so it cannot serve whisper."""
        scfg, cfg = self.scfg, self.cfg
        prompts = np.asarray(prompts)
        b, t = prompts.shape
        if t + scfg.max_new_tokens > scfg.s_cache:
            raise ValueError(
                f"prompt {t} + {scfg.max_new_tokens} new > cache {scfg.s_cache}")
        # The reference's embedding lookup clamps an out-of-range id; the
        # port's indexing does not, so the contract is checked here.
        if prompts.size and (prompts.min() < 0 or prompts.max() >= cfg.vocab_size):
            raise ValueError(f"prompt ids must lie in [0, {cfg.vocab_size})")
        if cfg.is_encoder_decoder and enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass enc_embeds")
        toks = torch.as_tensor(prompts.astype(np.int32), device=self.device)
        batch = {"tokens": toks}
        if enc_embeds is not None:
            batch["enc_embeds"] = torch.as_tensor(np.asarray(enc_embeds), device=self.device)
        logits, caches = self._prefill(self.model, batch)

        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        out = [toks]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        token = self._sample(logits, gen)
        pos = torch.full((b,), t, dtype=torch.int32, device=self.device)
        for i in range(scfg.max_new_tokens):
            out.append(token)
            if scfg.eos_id is not None:
                done = done | (token[:, 0] == scfg.eos_id)
                if bool(done.all()):
                    out.append(torch.full((b, scfg.max_new_tokens - i - 1), scfg.eos_id,
                                          dtype=torch.int32, device=self.device))
                    break
            logits, caches = self._step(self.model, caches, token, pos)
            token = self._sample(logits, gen)
            pos = pos + 1
        return torch.cat(out, dim=1).cpu().numpy()

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        # Gumbel-max, the algorithm of jax.random.categorical, on the port's
        # own random stream.
        scaled = logits.float() / self.scfg.temperature
        gumbel = -torch.log(torch.empty_like(scaled).exponential_(generator=gen))
        return torch.argmax(scaled + gumbel, dim=-1)[:, None].to(torch.int32)


def perplexity(cfg, model: torch.nn.Module, tokens: np.ndarray) -> float:
    """Convenience eval: exp(mean NLL) over a token batch, on the model's
    device."""
    api = build_model(cfg, device=_model_device(model))
    with torch.no_grad():
        _, metrics = api.loss(model, {"tokens": np.asarray(tokens)})
    return float(torch.exp(metrics["nll"]))


class QueueFullError(RuntimeError):
    """``submit()`` refused a request: the workload's queue is at
    ``max_queue_depth``.  The request was shed (counted in ``stats()``) —
    the caller owns the retry/drop policy."""


def _percentiles(samples) -> dict:
    """{'p50','p95','p99','mean','n'} of a latency sample window (ms)."""
    if not samples:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
    arr = np.asarray(samples, np.float64)
    p50, p95, p99 = np.percentile(arr, (50.0, 95.0, 99.0))
    return {
        "p50": float(p50), "p95": float(p95), "p99": float(p99),
        "mean": float(arr.mean()), "n": int(arr.size),
    }


# Unsigned dtypes PyTorch holds but cannot reduce (no min/max kernels), and
# the signed type each is widened to, exactly, before it reaches a plan.
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64,
          np.dtype(np.uint64): np.int64}


@dataclasses.dataclass(frozen=True)
class GLCMServeConfig:
    levels: int = 32
    # (H, W) for image specs, (D, H, W) for volumetric (ndim=3) specs.
    image_shape: tuple[int, ...] = (256, 256)
    batch_size: int = 8
    pairs: tuple[tuple[int, int], ...] = ((1, 0), (1, 45), (4, 0), (4, 45))
    scheme: str = "auto"          # any registered repro_torch.core.backends scheme
    # Haralick features per offset (True = all 14, a name tuple selects a
    # subset in that order); False → raw GLCMs.
    features: bool | tuple[str, ...] = True
    quantize: str | None = "uniform"
    # Spec-native configuration: when given, ``spec`` overrides the
    # levels/pairs/scheme/quantize fields above (which remain as the
    # keyword-compatible legacy surface). Region-structured specs serve
    # per-request texture maps; volumetric specs (spec.ndim == 3) serve
    # (D, H, W) volume requests.
    spec: GLCMSpec | None = None
    # Rolling-window video sessions: when set, the engine also compiles an
    # incremental temporal plan (core.stream_state) and exposes
    # open_stream/push/close_stream alongside the batch submit path.
    temporal_window: int | None = None
    # -- continuous-batching knobs -----------------------------------------
    # Latency deadline: dispatch a PARTIAL batch once the oldest queued
    # request is this old.  None = wait for a full batch (or an explicit
    # flush/result).
    max_wait_ms: float | None = None
    # Pre-declared partial-launch stack sizes (ascending, ending at
    # batch_size).  None = powers of two up to batch_size (1/2/4/8 for 8).
    buckets: tuple[int, ...] | None = None
    # Backpressure: bound on EACH workload's queue depth; submit() beyond it
    # raises QueueFullError and counts the shed.  None = unbounded.
    max_queue_depth: int | None = None
    # Bounded result store across all workloads: results never retrieved
    # evict oldest-first once this many are held (counted in stats()).
    max_results: int = 1024
    # Latency-sample window per workload for the stats() percentiles.
    stats_window: int = 2048

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.temporal_window is not None and self.temporal_window < 1:
            raise ValueError("temporal_window must be >= 1")
        if self.spec is not None and not isinstance(self.spec, GLCMSpec):
            raise ValueError(f"cfg.spec must be a GLCMSpec, got {self.spec!r}")
        if self.max_wait_ms is not None and not self.max_wait_ms > 0:
            raise ValueError(
                f"max_wait_ms must be positive or None, got {self.max_wait_ms}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 or None")
        if self.max_results < 1:
            raise ValueError("max_results must be >= 1")
        if self.stats_window < 1:
            raise ValueError("stats_window must be >= 1")
        bucket_sizes(self.batch_size, self.buckets)  # validate eagerly
        spec = self.glcm_spec()  # validate legacy fields (or explicit spec) now
        if len(self.image_shape) != spec.ndim:
            raise ValueError(
                f"image_shape {tuple(self.image_shape)} has rank "
                f"{len(self.image_shape)} but the engine spec is "
                f"ndim={spec.ndim}"
            )

    def glcm_spec(self) -> GLCMSpec:
        """The GLCMSpec this engine serves (explicit ``spec`` wins)."""
        if self.spec is not None:
            return self.spec
        return GLCMSpec(
            levels=self.levels,
            pairs=tuple(self.pairs),
            scheme=self.scheme,
            quantize=self.quantize,
        )

    @classmethod
    def from_dict(cls, d: dict) -> GLCMServeConfig:
        """The config described by ``d``, a dict of plain values such as
        ``dataclasses.asdict(cfg)`` of this class or of the reference
        package's ``GLCMServeConfig``: ``spec`` (a dict or None) is rebuilt
        through :meth:`GLCMSpec.from_dict`. Unknown keys raise ValueError;
        the usual validation runs."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown GLCMServeConfig fields {unknown}")
        d = dict(d)
        if isinstance(d.get("spec"), dict):
            d["spec"] = GLCMSpec.from_dict(d["spec"])
        return cls(**d)


@dataclasses.dataclass
class _Request:
    ticket: int
    image: np.ndarray
    priority: int
    submitted_at: float


class _Workload:
    """One registered (spec, image_shape) served by the engine: its queue,
    bucket plans, and metrics."""

    def __init__(self, wid, name, spec, image_shape, features, batch_size,
                 buckets, max_wait_ms, max_queue_depth, stats_window):
        self.wid = wid
        self.name = name
        self.spec = spec
        self.image_shape = tuple(image_shape)
        self.features = features
        self.batch_size = batch_size
        self.buckets = buckets
        self.max_wait_ms = max_wait_ms
        self.max_queue_depth = max_queue_depth
        self.queue: collections.deque[_Request] = collections.deque()
        self.plans: dict[int, object] = {}     # bucket → GLCMPlan (lazy)
        # metrics
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.results_evicted = 0
        self.batches = 0
        self.deadline_dispatches = 0
        self.occupancy: dict[int, dict[int, int]] = {}  # bucket → {occ: n}
        self.queue_ms: collections.deque = collections.deque(maxlen=stats_window)
        self.service_ms: collections.deque = collections.deque(maxlen=stats_window)
        self.e2e_ms: collections.deque = collections.deque(maxlen=stats_window)
        # per-phase dispatch breakdown (one sample per batch, ms)
        self.pad_ms: collections.deque = collections.deque(maxlen=stats_window)
        self.launch_ms: collections.deque = collections.deque(maxlen=stats_window)
        self.readback_ms: collections.deque = collections.deque(maxlen=stats_window)
        # cached metrics-registry handles: the dispatch path pays one
        # inc()/observe(), never a registry lookup
        reg = obs_metrics.get_registry()
        self.m_submitted = reg.counter(
            "repro_serve_submitted_total", "requests accepted by submit()",
            workload=name)
        self.m_served = reg.counter(
            "repro_serve_served_total", "requests completed", workload=name)
        self.m_shed = reg.counter(
            "repro_serve_shed_total", "requests shed by backpressure",
            workload=name)
        self.m_batches = reg.counter(
            "repro_serve_batches_total", "batches dispatched", workload=name)
        self.m_deadline = reg.counter(
            "repro_serve_deadline_dispatches_total",
            "partial batches launched by deadline expiry", workload=name)
        self.m_queue_depth = reg.gauge(
            "repro_serve_queue_depth", "requests currently queued",
            workload=name)
        self.m_phase = {
            phase: reg.histogram(
                "repro_serve_phase_ms", "dispatch phase latency (ms)",
                workload=name, phase=phase)
            for phase in ("queue", "pad", "launch", "readback")
        }


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, whose ops
    return when done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GLCMEngine:
    """Continuous-batching, multi-workload texture-feature server.

    ``submit(image, workload=0, priority=0)`` enqueues one request — an
    (H, W) image, or a (D, H, W) volume for a volumetric workload —
    validated eagerly (rank/shape/dtype) so malformed requests fail at
    submit time, never inside the batched dispatch — and returns a ticket.
    A full batch auto-dispatches; with ``cfg.max_wait_ms`` set, ``poll()``
    (or any later ``submit``) also dispatches a *partial* batch once the
    oldest queued request hits the deadline, padded to the smallest
    pre-declared bucket size that fits.  ``flush()`` forces dispatch of
    everything still queued.  ``result(ticket)`` returns the request's output
    exactly once (flushing its workload if still queued); asking again, for a
    never-issued ticket, or for a result evicted from the bounded store,
    raises ``KeyError``.  ``map(images)`` is the batch-submit convenience.

    Per request: Haralick features (len(pairs), n_feats) when the workload's
    ``features``, else the raw GLCM stack (len(pairs), L, L), as a numpy
    array; a region-structured spec prefixes it with its (gh, gw)
    tile/window grid (a texture map per request).

    **Device.**  ``device=None`` means the card (see
    ``core.plan.resolve_device``; without one the constructor raises).
    Every bucket plan and the stream plan are compiled for that device; only
    ``device="cpu"`` runs on the CPU.

    **Request dtypes.**  Every numpy integer, floating and bool dtype is
    admitted, as in the reference, and goes to the plan as given, with two
    conversions made here when it is validated: a non-native byte order
    (``'>u2'``, ``'>f4'``) is swapped to native, since ``torch.from_numpy``
    takes only native arrays; and PyTorch has no min/max for uint16, uint32
    and uint64 tensors, so such a request is widened exactly — uint16 to
    int32, uint32 and uint64 to int64 — and a uint64 value past int64's
    range is refused with ValueError.  (The reference,
    with JAX's 64-bit types off, narrows int64/uint64 requests to 32 bits,
    which wraps values outside them; within them both give the same
    answer.)

    **Multiplexing.**  ``register(spec, image_shape) -> workload_id`` adds a
    workload with its own queue and metrics; all workloads share the
    dispatch loop and the bounded-LRU plan cache, so an engine serving N
    specs builds exactly the plans N dedicated engines would — and a
    request's counts are bit-identical to a dedicated single-spec engine's
    (batched compute is per-image independent).  The config's own spec is
    workload 0 (``self.plan`` is its full-batch plan).

    **Dispatch order.**  Within a workload, requests are dequeued by weighted
    priority: effective priority = ``priority`` + queued-age /
    ``max_wait_ms`` (so low-priority requests age upward instead of
    starving; ties are FIFO), and a request PAST its deadline outranks any
    priority.  A deadline-triggered dispatch always includes the oldest
    request.  Without a deadline configured, priority order is strict.

    ``pause()``/``resume()`` suspend and restore dispatch; ``warmup()`` runs
    every bucket plan once on zeros, so no request pays a first call (on the
    card that is also where the CUDA kernels are built, if nothing has built
    them yet).

    ``clock`` injects a monotonic time source (seconds) for deterministic
    deadline tests and virtual-time replay; the default is
    ``time.monotonic``.

    Video sessions (``cfg.temporal_window=w``): ``open_stream()`` allocates a
    rolling-window session (optionally resuming a checkpointed
    :class:`~repro_torch.core.stream_state.GLCMStreamState` or its
    ``state_dict()``, rebuilt on the engine's device), ``push(sid, frame)``
    consumes one frame and returns the exact w-frame-window features as a
    numpy array (one incremental delta, not a window recompute), and
    ``close_stream(sid)`` retires the session and returns its final state,
    on the engine's device, for checkpointing.  Sessions validate frames
    against workload 0's shape and coexist with the batch traffic.
    """

    def __init__(self, cfg: GLCMServeConfig = GLCMServeConfig(), *, clock=None,
                 tracer=None, device=None):
        self.cfg = cfg
        self.spec = cfg.glcm_spec()
        self.device = resolve_device(device)
        self._clock = clock if clock is not None else time.monotonic
        # Observability: injected tracer (default = the process-global one,
        # disabled unless REPRO_TRACE=1 / set_tracer) and the always-on
        # flight recorder, both on the engine's own clock.
        self.tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self.flight = FlightRecorder(capacity=256, clock=self._clock)
        self.last_incident: dict | None = None
        self._m_frames = obs_metrics.get_registry().counter(
            "repro_serve_frames_streamed_total",
            "video frames consumed by stream sessions")
        self._workloads: dict[int, _Workload] = {}
        self._next_workload = 0
        self.register(
            self.spec, cfg.image_shape, features=cfg.features,
            batch_size=cfg.batch_size, buckets=cfg.buckets, name="default",
        )
        # The full-batch plan of workload 0, compiled eagerly (spec/shape
        # validation at construction; equal configs share it through the
        # plan cache).
        w0 = self._workloads[0]
        self.plan = compile_plan(
            self.spec, (cfg.batch_size, *cfg.image_shape), features=cfg.features,
            device=self.device,
        )
        w0.plans[cfg.batch_size] = self.plan
        self.stream_plan = (
            compile_plan(
                self.spec, tuple(cfg.image_shape), features=cfg.features,
                temporal_window=cfg.temporal_window, device=self.device,
            )
            if cfg.temporal_window is not None else None
        )
        self._results: collections.OrderedDict[int, tuple[int, np.ndarray]] = (
            collections.OrderedDict()
        )
        self._pending_wid: dict[int, int] = {}    # queued ticket → workload
        self._streams: dict[int, GLCMStreamState] = {}
        self._next_ticket = 0
        self._next_stream = 0
        self._paused = False
        self.batches_dispatched = 0
        self.images_served = 0
        self.frames_streamed = 0
        self.dispatch_log: collections.deque = collections.deque(maxlen=256)

    # -- workload registry -------------------------------------------------

    def register(
        self,
        spec: GLCMSpec,
        image_shape: tuple[int, ...],
        *,
        features: bool | tuple[str, ...] | None = None,
        batch_size: int | None = None,
        buckets: tuple[int, ...] | None = None,
        max_wait_ms: float | None | object = "default",
        max_queue_depth: int | None | object = "default",
        name: str | None = None,
    ) -> int:
        """Add a workload (a served (spec, image_shape)); returns its id.

        Unset knobs inherit the engine config's values.  The workload's
        bucket plans resolve lazily through the shared plan cache, so
        registering is cheap and equal specs never rebuild.
        """
        if not isinstance(spec, GLCMSpec):
            raise ValueError(f"spec must be a GLCMSpec, got {spec!r}")
        image_shape = tuple(int(s) for s in image_shape)
        if len(image_shape) != spec.ndim:
            raise ValueError(
                f"image_shape {image_shape} has rank {len(image_shape)} but "
                f"the workload spec is ndim={spec.ndim}"
            )
        batch_size = self.cfg.batch_size if batch_size is None else batch_size
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        wid = self._next_workload
        self._next_workload += 1
        self._workloads[wid] = _Workload(
            wid=wid,
            name=name if name is not None else f"workload{wid}",
            spec=spec,
            image_shape=image_shape,
            features=self.cfg.features if features is None else features,
            batch_size=batch_size,
            buckets=bucket_sizes(batch_size, buckets),
            max_wait_ms=(self.cfg.max_wait_ms if max_wait_ms == "default"
                         else max_wait_ms),
            max_queue_depth=(self.cfg.max_queue_depth
                             if max_queue_depth == "default"
                             else max_queue_depth),
            stats_window=self.cfg.stats_window,
        )
        return wid

    def workloads(self) -> tuple[int, ...]:
        return tuple(self._workloads)

    def _workload(self, workload: int) -> _Workload:
        try:
            return self._workloads[workload]
        except KeyError:
            raise KeyError(
                f"workload {workload} is not registered; known ids: "
                f"{sorted(self._workloads)}"
            ) from None

    def _plan_for(self, w: _Workload, bucket: int):
        plan = w.plans.get(bucket)
        if plan is None:
            plan = compile_plan(
                w.spec, (bucket, *w.image_shape), features=w.features,
                device=self.device,
            )
            w.plans[bucket] = plan
        return plan

    def warmup(self, workload: int | None = None) -> None:
        """Build AND run every bucket plan (on zeros, synchronised) so no
        live request pays a first call; per workload, or all when None."""
        wids = [workload] if workload is not None else list(self._workloads)
        for wid in wids:
            w = self._workload(wid)
            for bucket in w.buckets:
                stack = torch.zeros((bucket, *w.image_shape), dtype=torch.float32,
                                    device=self.device)
                self._plan_for(w, bucket)(stack)
        _sync(self.device)

    # -- request validation ------------------------------------------------

    def _validate_request(self, image: np.ndarray, *, kind: str,
                          want: tuple[int, ...]) -> np.ndarray:
        # Validate rank/shape/dtype EAGERLY: a malformed request must fail at
        # submit/push time with a clear error, never later inside the batched
        # dispatch (where it would take the whole batch down).
        image = np.asarray(image)
        if image.ndim != len(want):
            raise ValueError(
                f"{kind} rank {image.ndim} (shape {image.shape}) != workload "
                f"rank {len(want)}: this workload serves "
                f"{'(D, H, W) volumes' if len(want) == 3 else '(H, W) images'} "
                f"of shape {want}"
            )
        if image.shape != want:
            raise ValueError(
                f"{kind} shape {image.shape} != engine shape {want}")
        if not (np.issubdtype(image.dtype, np.integer)
                or np.issubdtype(image.dtype, np.floating)
                or np.issubdtype(image.dtype, np.bool_)):
            raise ValueError(
                f"{kind} dtype {image.dtype} is not a numeric gray-level "
                f"type; expected an integer or float array"
            )
        # See the class docstring (request dtypes): native byte order first.
        image = image.astype(image.dtype.newbyteorder("="), copy=False)
        wide = _WIDEN.get(image.dtype)
        if wide is not None:
            # See the class docstring (request dtypes): an exact widening.
            if (image.dtype == np.uint64 and image.size
                    and image.max() > np.iinfo(np.int64).max):
                raise ValueError(
                    f"{kind} holds uint64 values past the int64 range, which "
                    f"the engine cannot widen exactly")
            image = image.astype(wide)
        return image

    # -- rolling-window video sessions ------------------------------------

    def _require_streaming(self):
        if self.stream_plan is None:
            raise ValueError(
                "this engine was built without cfg.temporal_window; "
                "streaming sessions are disabled"
            )

    def open_stream(self, *, state=None) -> int:
        """Allocate a video session; ``state=`` resumes a checkpoint (a
        ``GLCMStreamState`` or its ``state_dict()``, rebuilt on the engine's
        device).  Returns the session id for ``push``/``close_stream``."""
        self._require_streaming()
        if state is None:
            state = self.stream_plan.init_state()
        elif isinstance(state, dict):
            state = GLCMStreamState.from_state_dict(state, device=self.device)
        if state.window != self.cfg.temporal_window:
            raise ValueError(
                f"checkpointed state has window {state.window}, engine "
                f"serves temporal_window={self.cfg.temporal_window}"
            )
        sid = self._next_stream
        self._next_stream += 1
        self._streams[sid] = state
        return sid

    def push(self, stream_id: int, frame: np.ndarray) -> np.ndarray:
        """Consume one frame of session ``stream_id``; returns the rolling
        window's features (or raw counts when ``cfg.features`` is False) as
        a numpy array."""
        self._require_streaming()
        if stream_id not in self._streams:
            raise KeyError(f"stream {stream_id} is unknown or closed")
        frame = self._validate_request(
            frame, kind="frame", want=tuple(self.cfg.image_shape))
        t0 = self._clock()
        state, out = self.stream_plan.update(self._streams[stream_id], frame)
        result = out.cpu().numpy()
        self._streams[stream_id] = state
        self.frames_streamed += 1
        self._m_frames.inc()
        if self.tracer.enabled:
            self.tracer.add_span(
                "glcm.stream_push", t0, self._clock(),
                corr=f"stream-{stream_id}", stream=stream_id,
                frames_seen=self.frames_streamed)
        return result

    def close_stream(self, stream_id: int) -> GLCMStreamState:
        """Retire the session, returning its final ``GLCMStreamState`` on
        the engine's device (feed it back to ``open_stream(state=...)`` — or
        persist it via ``state.save(path)`` — to resume)."""
        self._require_streaming()
        if stream_id not in self._streams:
            raise KeyError(f"stream {stream_id} is unknown or closed")
        return self._streams.pop(stream_id)

    # -- continuous-batched one-shot requests ------------------------------

    def submit(self, image: np.ndarray, *, workload: int = 0,
               priority: int = 0) -> int:
        """Enqueue one request for ``workload``; returns its ticket.

        Raises :class:`QueueFullError` (the request is shed and counted)
        when the workload's queue is at ``max_queue_depth``.  Submitting
        also advances the dispatch loop: full buckets launch immediately,
        and any workload whose oldest request has outlived its deadline
        launches a partial bucket.
        """
        w = self._workload(workload)
        image = self._validate_request(
            image, kind="request", want=w.image_shape)
        if (w.max_queue_depth is not None
                and len(w.queue) >= w.max_queue_depth):
            w.shed += 1
            w.m_shed.inc()
            # Post-mortem: dump the flight ring so "what led up to the
            # overload" is answerable without tracing having been on.
            self.flight.record(
                "shed", workload=w.wid, name=w.name,
                queue_depth=len(w.queue), sheds=w.shed)
            self.last_incident = self.flight.dump(
                reason=f"QueueFullError: workload {w.wid} ({w.name}) at "
                       f"max_queue_depth={w.max_queue_depth}")
            raise QueueFullError(
                f"workload {w.wid} ({w.name}): queue is at "
                f"max_queue_depth={w.max_queue_depth}; request shed "
                f"(sheds so far: {w.shed})"
            )
        ticket = self._next_ticket
        self._next_ticket += 1
        w.queue.append(_Request(ticket, image, priority, self._clock()))
        w.submitted += 1
        w.m_submitted.inc()
        w.m_queue_depth.set(len(w.queue))
        self._pending_wid[ticket] = w.wid
        if self.tracer.enabled:
            # the correlation id of this request's whole span tree
            self.tracer.event("glcm.submit", ticket=ticket, workload=w.name,
                              priority=priority)
        self.poll()
        return ticket

    def poll(self) -> int:
        """Advance the dispatch loop once: launch every full bucket, then
        every deadline-expired partial bucket.  Returns the number of
        batches dispatched.  Serving loops call this between arrivals; it
        is also called from ``submit``."""
        if self._paused:
            return 0
        n = 0
        now = self._clock()
        for w in self._workloads.values():
            while len(w.queue) >= w.batch_size:
                self._dispatch(w, w.batch_size, now=now)
                n += 1
            if (w.max_wait_ms is not None and w.queue
                    and (now - w.queue[0].submitted_at) * 1e3 >= w.max_wait_ms):
                # Launch the largest bucket the queue FILLS (5 queued → a
                # full bucket-4 launch; the leftover's own deadline is
                # later); pad up only when even the smallest bucket doesn't
                # fill.
                k = max((b for b in w.buckets if b <= len(w.queue)),
                        default=len(w.queue))
                self._dispatch(w, k, now=now, deadline=True)
                n += 1
        return n

    def next_deadline(self) -> float | None:
        """The earliest clock time (in ``clock`` units) any workload's
        deadline dispatch falls due, or None when nothing queued has a
        deadline.  Event-driven serving loops sleep (or warp a virtual
        clock) to this instant instead of polling blindly."""
        due = None
        for w in self._workloads.values():
            if w.max_wait_ms is not None and w.queue:
                t = w.queue[0].submitted_at + w.max_wait_ms * 1e-3
                due = t if due is None else min(due, t)
        return due

    def pause(self) -> None:
        """Suspend dispatch: submits only queue (sheds still apply)."""
        self._paused = True

    def resume(self) -> int:
        """Re-enable dispatch and advance the loop once."""
        self._paused = False
        return self.poll()

    def flush(self, workload: int | None = None) -> None:
        """Dispatch everything queued (one workload, or all when None)."""
        wids = [workload] if workload is not None else list(self._workloads)
        for wid in wids:
            w = self._workload(wid)
            while w.queue:
                self._dispatch(w, min(len(w.queue), w.batch_size),
                               now=self._clock())

    def result(self, ticket: int) -> np.ndarray:
        """The request's output, exactly once (flushes its workload if the
        ticket is still queued)."""
        if ticket not in self._results and ticket in self._pending_wid:
            self.flush(self._pending_wid[ticket])
        if ticket not in self._results:
            raise KeyError(
                f"ticket {ticket} is unknown, its result was already "
                f"retrieved, or it was evicted from the bounded result "
                f"store (max_results={self.cfg.max_results})"
            )
        return self._results.pop(ticket)[1]

    def map(self, images, *, workload: int = 0) -> np.ndarray:
        """Submit many images, flush, and return results stacked in order."""
        tickets = [self.submit(im, workload=workload) for im in images]
        self.flush(workload)
        return np.stack([self.result(t) for t in tickets])

    def latencies(self, workload: int = 0, kind: str = "e2e") -> np.ndarray:
        """The retained latency samples (ms) of one workload:
        ``kind`` ∈ {"queue", "service", "e2e"}.  Bounded by
        ``stats_window`` — a sliding window, not full history."""
        w = self._workload(workload)
        try:
            samples = {"queue": w.queue_ms, "service": w.service_ms,
                       "e2e": w.e2e_ms}[kind]
        except KeyError:
            raise ValueError(
                f"kind must be 'queue', 'service' or 'e2e', got {kind!r}"
            ) from None
        return np.asarray(samples, np.float64)

    def stats(self) -> dict:
        """The observability surface: per-workload queue depth,
        p50/p95/p99 queue/service/end-to-end latency (ms), batch-occupancy
        histogram ({bucket: {occupancy: count}}), submit/serve/shed/
        eviction counters — plus engine-wide totals and the shared
        plan-cache hit rate."""
        per = {}
        for wid, w in self._workloads.items():
            per[wid] = {
                "name": w.name,
                "scheme": w.spec.scheme,
                "ndim": w.spec.ndim,
                "region": w.spec.region,
                "batch_size": w.batch_size,
                "buckets": tuple(w.buckets),
                "queue_depth": len(w.queue),
                "submitted": w.submitted,
                "served": w.served,
                "shed": w.shed,
                "results_evicted": w.results_evicted,
                "batches": w.batches,
                "deadline_dispatches": w.deadline_dispatches,
                "batch_occupancy": {
                    b: dict(h) for b, h in sorted(w.occupancy.items())
                },
                "queue_ms": _percentiles(w.queue_ms),
                "service_ms": _percentiles(w.service_ms),
                "e2e_ms": _percentiles(w.e2e_ms),
                # per-phase dispatch breakdown (one sample per batch)
                "pad_ms": _percentiles(w.pad_ms),
                "launch_ms": _percentiles(w.launch_ms),
                "readback_ms": _percentiles(w.readback_ms),
            }
        return {
            "batches_dispatched": self.batches_dispatched,
            "images_served": self.images_served,
            "frames_streamed": self.frames_streamed,
            "results_held": len(self._results),
            "open_streams": len(self._streams),
            "paused": self._paused,
            "flight_records": len(self.flight),
            "incidents": self.flight.dumps,
            "plan_cache": plan_cache_stats(),
            "workloads": per,
        }

    # -- dispatch core -----------------------------------------------------

    def _take(self, w: _Workload, n: int, now: float,
              deadline: bool) -> list[_Request]:
        """Dequeue ``n`` requests by weighted priority (priority + queued
        age in deadline units; FIFO ties).  A deadline dispatch always
        includes the oldest request — its latency bound is the trigger."""
        if n >= len(w.queue):
            taken = list(w.queue)
            w.queue.clear()
            return taken
        scale = 1e3 / w.max_wait_ms if w.max_wait_ms else 0.0

        def score(idx_req):
            idx, r = idx_req
            boost = (now - r.submitted_at) * scale
            # A request PAST its deadline outranks any priority: the
            # deadline is a per-request latency bound, not a tiebreak.
            if boost >= 1.0:
                boost += 1e9
            return (-(r.priority + boost), idx)

        ranked = sorted(enumerate(w.queue), key=score)
        picked = {idx for idx, _ in ranked[:n]}
        if deadline and 0 not in picked:
            picked.discard(ranked[n - 1][0])
            picked.add(0)
        taken = [r for idx, r in enumerate(w.queue) if idx in picked]
        w.queue = collections.deque(
            r for idx, r in enumerate(w.queue) if idx not in picked
        )
        return taken

    def _dispatch(self, w: _Workload, n: int, *, now: float,
                  deadline: bool = False) -> None:
        reqs = self._take(w, n, now, deadline)
        k = len(reqs)
        bucket = pick_bucket(w.buckets, k)
        # Phase boundaries (engine clock): pad → launch → readback.  Launch
        # is the host→device copy, the plan call and a device sync, so the
        # launch/readback split — and any trace span built from it — is
        # device time, not enqueue time.
        t_pad0 = self._clock()
        try:
            plan = self._plan_for(w, bucket)
            stack, _ = pad_stack([r.image for r in reqs], bucket)
            t_disp = self._clock()
            out_dev = plan(torch.from_numpy(stack).to(plan.device))
            _sync(plan.device)
            t_launch = self._clock()
            out = out_dev.cpu().numpy()
        except Exception as exc:
            # Post-mortem before propagating: the flight ring holds the
            # dispatches leading up to the failure.
            self.flight.record(
                "dispatch_error", workload=w.wid, name=w.name,
                bucket=bucket, occupancy=k,
                tickets=[r.ticket for r in reqs],
                error=f"{type(exc).__name__}: {exc}")
            self.last_incident = self.flight.dump(
                reason=f"dispatch error in workload {w.wid} ({w.name}): "
                       f"{type(exc).__name__}: {exc}")
            raise
        t_done = self._clock()
        pad_ms = (t_disp - t_pad0) * 1e3
        launch_ms = (t_launch - t_disp) * 1e3
        readback_ms = (t_done - t_launch) * 1e3
        for i, r in enumerate(reqs):
            self._pending_wid.pop(r.ticket, None)
            self._store_result(r.ticket, w.wid, out[i])
            w.queue_ms.append((t_disp - r.submitted_at) * 1e3)
            w.service_ms.append((t_done - t_disp) * 1e3)
            w.e2e_ms.append((t_done - r.submitted_at) * 1e3)
            w.m_phase["queue"].observe((t_disp - r.submitted_at) * 1e3)
        w.pad_ms.append(pad_ms)
        w.launch_ms.append(launch_ms)
        w.readback_ms.append(readback_ms)
        w.m_phase["pad"].observe(pad_ms)
        w.m_phase["launch"].observe(launch_ms)
        w.m_phase["readback"].observe(readback_ms)
        w.batches += 1
        w.served += k
        w.m_batches.inc()
        w.m_served.inc(k)
        if deadline:
            w.deadline_dispatches += 1
            w.m_deadline.inc()
        w.m_queue_depth.set(len(w.queue))
        w.occupancy.setdefault(bucket, {})
        w.occupancy[bucket][k] = w.occupancy[bucket].get(k, 0) + 1
        self.batches_dispatched += 1
        self.images_served += k
        self.dispatch_log.append({
            "workload": w.wid, "bucket": bucket, "occupancy": k,
            "tickets": tuple(r.ticket for r in reqs),
            "deadline": deadline,
        })
        self.flight.record(
            "dispatch", workload=w.wid, name=w.name, bucket=bucket,
            occupancy=k, deadline=deadline, queue_depth=len(w.queue),
            pad_ms=round(pad_ms, 3), launch_ms=round(launch_ms, 3),
            readback_ms=round(readback_ms, 3))
        tr = self.tracer
        if tr.enabled:
            # One batch-level span tree on the engine's track…
            sid = tr.add_span(
                "glcm.dispatch", t_pad0, t_done, workload=w.name,
                bucket=bucket, occupancy=k, deadline=deadline,
                backend=plan.spec.scheme)
            tr.add_span("glcm.pad", t_pad0, t_disp, parent=sid,
                        workload=w.name)
            tr.add_span("glcm.launch", t_disp, t_launch, parent=sid,
                        workload=w.name, backend=plan.spec.scheme,
                        synced=True)
            tr.add_span("glcm.readback", t_launch, t_done, parent=sid,
                        workload=w.name)
            # …and one span tree per request under its ticket correlation
            # id: the request's whole life, submit() to result ready.
            for r in reqs:
                root = tr.add_span(
                    "glcm.request", r.submitted_at, t_done, corr=r.ticket,
                    ticket=r.ticket, workload=w.name, priority=r.priority,
                    bucket=bucket, occupancy=k, deadline=deadline)
                tr.add_span("glcm.queue_wait", r.submitted_at, t_pad0,
                            parent=root, corr=r.ticket)
                tr.add_span("glcm.pad", t_pad0, t_disp, parent=root,
                            corr=r.ticket)
                tr.add_span("glcm.launch", t_disp, t_launch, parent=root,
                            corr=r.ticket, backend=plan.spec.scheme,
                            synced=True)
                tr.add_span("glcm.readback", t_launch, t_done, parent=root,
                            corr=r.ticket)

    def _store_result(self, ticket: int, wid: int, value: np.ndarray) -> None:
        self._results[ticket] = (wid, value)
        while len(self._results) > self.cfg.max_results:
            _, (old_wid, _) = self._results.popitem(last=False)
            self._workloads[old_wid].results_evicted += 1
