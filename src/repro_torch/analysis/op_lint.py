"""An op-record lint engine: ONE recorder of a plan's run + a registry of
contract rules.

Counterpart of ``repro.analysis.jaxpr_lint``. The invariants this repo
ships ("optimization without losing the computational accuracy") are
structural properties of the program a plan runs, not of any one output: a
fused-quantize plan must hold no integer image-shaped intermediate, an
identity-quantize plan no float binning arithmetic, an ``accum="int"`` plan
no float count accumulation, a ``select=``-pruned feature plan no O(L³)
eigendecomposition — and a plan on the card must run its kernels, never
their plain versions.

The reference reads these properties off a jaxpr traced abstractly. A
PyTorch plan runs eagerly and launches its kernels through ``ctypes``,
which neither FX, ``torch.export`` nor meta tensors can follow. So this
module *records one real call* instead:

* :func:`record_plan` runs the plan once, on its own device, on a seeded
  input of its compiled shape, under a ``TorchDispatchMode`` that writes one
  :class:`OpRecord` per aten op (:func:`record_call` records any function
  the same way) — name, output shapes, dtypes and devices,
  input shapes and devices, whether an output aliases the plan's input, and
  the scopes open at that moment (:mod:`repro_torch.analysis.scopes`:
  ``kernel:<name>`` for a plain version run in place of its kernel, the
  ``pallas_call`` boundary; ``host`` for the host-native round trip, the
  ``pure_callback``; ``tail`` for the float64 Haralick tail). The mode
  reads metadata only, so it adds no device sync. Kernel launches are the
  deltas of the ``.launches`` counters of the wrappers of
  ``kernels.build.TABLE`` around the call.
* small queries over a :class:`PlanRecord` — :func:`op_names`,
  :func:`has_op`, :func:`int_image_ops` — the counterparts of
  ``primitive_names``, ``has_primitive`` and ``int_image_eqns``.
* a rule registry (:class:`Rule`, :func:`register_rule`, :func:`get_rule`)
  of named contract checks over a :class:`LintContext`, and
  :func:`lint_plan`, which records a compiled plan and returns the
  :class:`Finding` tuple of every applicable rule.

Which rules apply to which plan is decided by the contract layer
(:mod:`repro_torch.analysis.contracts`); the CLI that sweeps the registry is
:mod:`repro_torch.analysis.audit`. The lint never swaps a kernel for its
plain version and never moves a CUDA plan to the CPU: it runs the plan
exactly as a caller would.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import scopes as _scopes
from repro_torch.kernels import build as _build
from repro_torch.kernels.mcc_kernel import second_eigenvalue

__all__ = [
    "Finding",
    "LintContext",
    "OpRecord",
    "PlanContractError",
    "PlanRecord",
    "Rule",
    "default_input_dtype",
    "eigh_ops",
    "get_rule",
    "has_op",
    "int_image_ops",
    "is_stream_plan",
    "lint_input",
    "lint_plan",
    "op_names",
    "record_call",
    "record_plan",
    "register_rule",
    "registered_rules",
]

# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of a recorded call. ``name`` is the op packet
    (``"aten.bincount"``); shapes, dtypes and devices are per output tensor,
    ``in_shapes`` / ``in_devices`` per input tensor; ``aliases_input`` says
    whether an output shares the plan input's storage (a view of it);
    ``scopes`` are the scopes open when it ran, outermost first;
    ``accumulate`` is ``index_put``'s flag."""

    name: str
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    devices: tuple[str, ...]
    in_shapes: tuple[tuple[int, ...], ...]
    in_devices: tuple[str, ...]
    aliases_input: bool
    scopes: tuple[str, ...]
    accumulate: bool = False

    @property
    def in_kernel(self) -> bool:
        """Whether a plain version ran this op in place of a kernel."""
        return any(s.startswith("kernel:") for s in self.scopes)

    def in_scope(self, name: str) -> bool:
        return name in self.scopes


@dataclasses.dataclass(frozen=True)
class PlanRecord:
    """One recorded call of a plan: its ops in order, the kernel launches
    it made (wrapper name → count) and the scopes it entered, in order."""

    ops: tuple[OpRecord, ...]
    launches: dict
    entered: tuple[str, ...] = ()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_ptr(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (NotImplementedError, RuntimeError):  # meta or storage-less tensors
        return 0


class _Recorder(TorchDispatchMode):
    """Writes one :class:`OpRecord` per aten op; reads metadata only."""

    def __init__(self, inputs: Iterable[torch.Tensor], rec: _scopes.Recording):
        super().__init__()
        self.ops: list[OpRecord] = []
        self._rec = rec
        self._input_ptrs = {p for p in map(_storage_ptr, inputs) if p}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = str(func.overloadpacket)
        accumulate = False
        if name in ("aten.index_put", "aten.index_put_", "aten._index_put_impl_"):
            accumulate = bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        self.ops.append(OpRecord(
            name=name,
            shapes=tuple(tuple(t.shape) for t in outs),
            dtypes=tuple(t.dtype for t in outs),
            devices=tuple(t.device.type for t in outs),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_devices=tuple(t.device.type for t in ins),
            aliases_input=any(_storage_ptr(t) in self._input_ptrs for t in outs),
            scopes=tuple(self._rec.stack),
            accumulate=accumulate,
        ))
        return out


def default_input_dtype(spec) -> torch.dtype:
    """The representative input dtype for linting a plan: raw float32
    pixels when the plan quantizes, int32 levels when it does not."""
    return torch.float32 if spec.quantize is not None else torch.int32


def is_stream_plan(plan) -> bool:
    """Whether ``plan`` is an incremental temporal plan (``GLCMStreamPlan``):
    it carries a rolling ``window`` and an ``update_fn`` step instead of a
    one-shot ``fn``."""
    return getattr(plan, "window", None) is not None and hasattr(plan, "update_fn")


def lint_input(plan, dtype=None) -> torch.Tensor:
    """The seeded input the lint runs ``plan`` on, on its device: raw
    float32 in [0, 1) when the plan quantizes (cast to ``dtype``), levels in
    [0, L) when it does not, 0..255 for uint8."""
    dtype = default_input_dtype(plan.spec) if dtype is None else dtype
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.uint8:
        return torch.randint(0, 256, plan.shape, generator=gen, device=dev, dtype=dtype)
    if plan.spec.quantize is not None:
        x = torch.rand(plan.shape, generator=gen, device=dev, dtype=torch.float32)
        return x.to(dtype)
    return torch.randint(0, plan.spec.levels, plan.shape, generator=gen, device=dev,
                         dtype=dtype)


def record_call(fn, *args, inputs: Iterable[torch.Tensor] = ()) -> PlanRecord:
    """Run ``fn(*args)`` once and record it: every aten op, the scopes it
    entered and the kernel launches it made. ``inputs`` are the tensors an
    output may alias without counting as a derived copy (the plan's input).
    With a CUDA tensor among ``args`` the device is synchronized after the
    call, so its device work ends inside the record. The launch counts are
    process-wide, so launches another thread makes during the call count
    too."""
    dev = next((t.device for t in _tensors(args) if t.device.type == "cuda"), None)
    kernels = _build.wrappers()
    before = [k.launches for k in kernels]
    with _scopes.recording() as rec, _Recorder(inputs, rec) as recorder:
        fn(*args)
    if dev is not None:
        torch.cuda.synchronize(dev)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    return PlanRecord(ops=tuple(recorder.ops), launches=launches, entered=tuple(rec.entered))


def record_plan(plan, dtype=None) -> PlanRecord:
    """Run ``plan`` once on :func:`lint_input` and record the call — the
    counterpart of the reference's ``trace_plan``. For a stream plan the
    recorded call is one ``update_fn(state, frame)`` step from
    ``init_state()`` (made before the recording starts)."""
    x = lint_input(plan, dtype)
    if is_stream_plan(plan):
        return record_call(plan.update_fn, plan.init_state(), x, inputs=[x])
    return record_call(plan.fn, x, inputs=[x])


def op_names(record: PlanRecord) -> set[str]:
    """The set of op names anywhere in ``record``, kernel scopes included."""
    return {op.name for op in record.ops}


def has_op(record: PlanRecord, name: str) -> bool:
    return any(op.name == name for op in record.ops)


def eigh_ops(record: PlanRecord) -> list[str]:
    """The eigendecompositions of ``record``, sorted: every op whose name
    holds "eig", and on the card ``kernel:second_eigenvalue`` where f14's
    eigensolver kernel launched (it leaves no op behind)."""
    found = sorted(n for n in op_names(record) if "eig" in n)
    if record.launches.get(second_eigenvalue.__name__):
        found.append(f"kernel:{second_eigenvalue.__name__}")
    return found


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _is_unsigned(dtype: torch.dtype) -> bool:
    return _is_integer(dtype) and not dtype.is_signed


def int_image_ops(
    record: PlanRecord, spatial: tuple[int, ...]
) -> list[tuple[str, tuple[int, ...], str]]:
    """Every op output that is an integer tensor covering the full
    ``spatial`` extent — what a materialized quantized image looks like.
    Returns (op name, shape, dtype) triples; empty means the call never held
    an image-shaped integer intermediate.

    Ops inside a ``kernel:*`` scope are skipped: a plain version stands for
    a kernel, whose binned block never reaches device memory (the
    reference's query stops at the ``pallas_call`` boundary). So are
    outputs that alias the plan's input: a view of a uint8 or int32 input
    is the input itself, not a derived copy."""
    spatial = tuple(int(s) for s in spatial)
    bad = []
    for op in record.ops:
        if op.in_kernel or op.aliases_input:
            continue
        for shape, dtype in zip(op.shapes, op.dtypes):
            if (
                _is_integer(dtype)
                and len(shape) >= len(spatial)
                and shape[len(shape) - len(spatial):] == spatial
            ):
                bad.append((op.name, shape, str(dtype)))
    return bad


# ---------------------------------------------------------------------------
# Rules: named contract checks over a recorded plan
# ---------------------------------------------------------------------------


class PlanContractError(ValueError):
    """A lint (``compile_plan(..., check="lint")`` or ``REPRO_PLAN_LINT=1``)
    found contract violations in the recorded plan. ``findings`` carries the
    full :class:`Finding` tuple."""

    def __init__(self, findings):
        self.findings = tuple(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"plan violates {len(self.findings)} recorded contract(s):\n{lines}"
        )


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: ``rule`` failed for ``backend`` on the plan
    described by ``spec`` (a compact repr) at ``shape``."""

    rule: str
    backend: str
    message: str
    spec: str = ""
    shape: tuple[int, ...] = ()

    def __str__(self) -> str:
        where = f"{self.backend} @ {self.shape}" if self.shape else self.backend
        return f"[{self.rule}] {where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class LintContext:
    """Everything a rule may inspect: the recorded call plus the plan's
    resolved spec, backend, concrete shape, input dtype and device.

    ``record`` is the :class:`PlanRecord` of one call (for a stream plan,
    one ``update(state, frame)`` step); ``features`` is the plan's canonical
    features argument (False, True, or a name tuple). For stream plans
    ``temporal_window`` is the rolling window and ``state_leaves`` the
    carry's ``meta`` tensors from ``state_struct()`` (counts, ring, pos,
    seen) — what ``stream-signed-accum`` audits."""

    record: PlanRecord | None
    spec: object
    backend: object          # core.backends.Backend
    shape: tuple[int, ...]
    dtype: torch.dtype
    features: bool | tuple[str, ...] = False
    fused_quantize: bool = False
    host_native: bool = False
    temporal_window: int | None = None
    state_leaves: tuple = ()
    device: torch.device = torch.device("cpu")

    @property
    def spatial(self) -> tuple[int, ...]:
        return tuple(self.shape[-self.spec.ndim:])

    @property
    def levels(self) -> int:
        return self.spec.levels

    def finding(self, rule: str, message: str) -> Finding:
        return Finding(rule=rule, backend=self.backend.name, message=message,
                       spec=_spec_summary(self.spec), shape=self.shape)


def _spec_summary(spec) -> str:
    bits = [f"L={spec.levels}", f"pairs={len(spec.pairs)}", f"ndim={spec.ndim}"]
    if spec.quantize:
        bits.append(f"quantize={spec.quantize}")
    if spec.region != "global":
        bits.append(f"region={spec.region}")
    if spec.accum != "auto":
        bits.append(f"accum={spec.accum}")
    return " ".join(bits)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named contract check.

    ``check(ctx)`` returns violation messages (empty list = clean). Rules
    never decide their own applicability: :mod:`repro_torch.analysis.
    contracts` maps capability fields and spec properties to the rules they
    imply, so a rule body may assume its preconditions hold."""

    name: str
    description: str
    check: Callable[[LintContext], list[str]]


_RULES: dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    if rule.name in _RULES:
        raise ValueError(f"lint rule {rule.name!r} is already registered")
    _RULES[rule.name] = rule
    return rule


def get_rule(name: str) -> Rule:
    try:
        return _RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {name!r}; available: {sorted(_RULES)}"
        ) from None


def registered_rules() -> tuple[str, ...]:
    return tuple(sorted(_RULES))


# ---------------------------------------------------------------------------
# The built-in rules
# ---------------------------------------------------------------------------


def _check_fused_no_int_image(ctx: LintContext) -> list[str]:
    return [
        f"integer image-shaped intermediate {shape} {dtype} (from {name!r}) — "
        "the quantized image was materialized despite caps.fused_quantize"
        for name, shape, dtype in int_image_ops(ctx.record, ctx.spatial)
    ]


register_rule(Rule(
    name="fused-no-int-image",
    description=(
        "A fused-quantize plan must never materialize the quantized image: "
        "no integer tensor spanning the full spatial extent may appear in "
        "the recorded call outside a kernel (binning happens on sliced pair "
        "planes or inside the kernel)."
    ),
    check=_check_fused_no_int_image,
))


def _check_identity_quantize_float_free(ctx: LintContext) -> list[str]:
    # Binning is floor((x - lo) / span * L): floor and div are its signature
    # ops and appear nowhere else in a post-processing-free counting plan.
    names = op_names(ctx.record)
    out = []
    for prim in ("floor", "div"):
        hits = sorted(n for n in names if n.startswith(f"aten.{prim}"))
        if hits:
            out.append(
                f"float binning arithmetic ({', '.join(hits)}) in a provably-identity "
                "quantize plan (uint8 input, levels=256, vrange (0, 255)) — "
                "the quantize stage must short-circuit to a dtype cast"
            )
    return out


register_rule(Rule(
    name="identity-quantize-float-free",
    description=(
        "When uniform quantization is provably the identity (uint8 input, "
        "levels=256, vrange pinned to (0, 255)) the recorded call must "
        "contain no binning arithmetic (floor/div), kernel scopes included: "
        "a dtype cast suffices and anything more is wasted memory traffic."
    ),
    check=_check_identity_quantize_float_free,
))


# Count accumulators: ops that add votes into cells.
_COUNT_ACCUMULATORS = ("aten.bincount", "aten.scatter_add", "aten.scatter_add_",
                       "aten.index_add", "aten.index_add_")
_INDEX_PUTS = ("aten.index_put", "aten.index_put_", "aten._index_put_impl_")
# Matmuls that can vote (one-hot products).
_MATMULS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten._int_mm")


def _is_count_shaped(shape: tuple[int, ...], levels: int) -> bool:
    """Whether an accumulator output looks like GLCM counts: trailing
    (L, L) cells, or the flat (… · L²,) linearized form of a scatter."""
    if len(shape) >= 2 and shape[-2:] == (levels, levels):
        return True
    cells = levels * levels
    return len(shape) == 1 and shape[0] % cells == 0


def _is_vote_matmul(op: OpRecord, levels: int) -> bool:
    """Whether a matmul is a vote matmul: (…, L, L) output from at least one
    pair-stream-shaped input (trailing dims ≠ (L, L) — which excludes the
    Haralick f14 ``A·Aᵀ`` square-matrix product)."""
    if not op.shapes:
        return False
    shape = op.shapes[0]
    if len(shape) < 2 or shape[-2:] != (levels, levels):
        return False
    return any(len(s) >= 2 and s[-2:] != (levels, levels) for s in op.in_shapes)


def _check_accum_exact_width(ctx: LintContext) -> list[str]:
    out = []
    levels = ctx.levels
    for op in ctx.record.ops:
        if not op.dtypes:
            continue
        shape, dtype = op.shapes[0], op.dtypes[0]
        if _is_integer(dtype):
            continue
        if op.name in _COUNT_ACCUMULATORS or (op.name in _INDEX_PUTS and op.accumulate):
            if _is_count_shaped(shape, levels):
                out.append(
                    f"count accumulator {op.name!r} accumulates in {dtype} "
                    f"(shape {shape}) — accum='int' requires exact integer "
                    "cells widened only at the final reduction"
                )
        elif op.name in _MATMULS and _is_vote_matmul(op, levels):
            out.append(
                f"vote matmul {op.name!r} accumulates in {dtype} (shape {shape}) — "
                "accum='int' requires integer votes with int32 accumulation"
            )
    return out


register_rule(Rule(
    name="accum-exact-width",
    description=(
        "An accum='int' plan must accumulate votes in exact integer "
        "arithmetic: every count accumulator (bincount, scatter_add, "
        "index_add, accumulating index_put) and every vote matmul produces "
        "an integer dtype; the plan's (…, L, L) counts stay int32 and widen "
        "to float32 only where they are normalized."
    ),
    check=_check_accum_exact_width,
))


def _host_syncs(ctx: LintContext) -> list[str]:
    """Device→host copies and scalar reads of a CUDA plan outside the
    ``host`` scope: ops whose inputs lie on the card and whose outputs on
    the host, and every ``aten._local_scalar_dense`` of a card tensor."""
    if ctx.device.type != "cuda":
        return []
    out = []
    for op in ctx.record.ops:
        if op.in_scope("host") or "cuda" not in op.in_devices:
            continue
        if op.name == "aten._local_scalar_dense" or (
            op.devices and all(d == "cpu" for d in op.devices)
        ):
            out.append(op.name)
    return out


def _check_no_host_callback(ctx: LintContext) -> list[str]:
    n_host = sum(1 for s in ctx.record.entered if s == "host")
    syncs = _host_syncs(ctx)
    where = f"{n_host} host scope(s)" + (
        f" and {len(syncs)} device→host read(s) ({', '.join(sorted(set(syncs)))})"
        if syncs else ""
    )
    n = n_host + len(syncs)
    if ctx.host_native:
        if n != 1:
            return [
                "host-native plan must make exactly ONE host round trip (the "
                f"NumPy counting core), found {n}: {where}"
            ]
        return []
    if n:
        return [
            f"device plan makes {n} host round trip(s): {where} — every round "
            "trip through the host serializes the device stream"
        ]
    return []


register_rule(Rule(
    name="no-host-callback",
    description=(
        "Device-backend plans must make no host round trip: no 'host' scope "
        "and, on the card, no device→host copy or scalar read outside one; "
        "the host-native backend's plan must make exactly one (its NumPy "
        "counting core)."
    ),
    check=_check_no_host_callback,
))


def _check_pruned_no_eigh(ctx: LintContext) -> list[str]:
    bad = eigh_ops(ctx.record)
    if bad:
        return [
            f"O(L³) eigendecomposition {bad} in a plan whose feature "
            "selection excludes max_correlation_coefficient — select= must "
            "prune it"
        ]
    return []


register_rule(Rule(
    name="pruned-no-eigh",
    description=(
        "A plan whose Haralick selection excludes "
        "max_correlation_coefficient (including features=False) must "
        "contain no eigendecomposition, tail included — the O(L³) term "
        "select= exists to prune."
    ),
    check=_check_pruned_no_eigh,
))


def _check_no_f64_promotion(ctx: LintContext) -> list[str]:
    out = []
    for op in ctx.record.ops:
        if op.in_scope("tail"):
            continue
        for shape, dtype in zip(op.shapes, op.dtypes):
            if dtype in (torch.float64, torch.complex128):
                out.append(
                    f"{dtype} intermediate {shape} (from {op.name!r}) outside the "
                    "Haralick tail — counting, symmetric and normalize are a "
                    "float32/int32 contract; f64 doubles bandwidth and is slow "
                    "on the card"
                )
                break
        if len(out) >= 4:  # enough evidence; avoid message floods
            break
    return out


register_rule(Rule(
    name="no-f64-promotion",
    description=(
        "No float64 value may appear in a recorded plan outside the 'tail' "
        "scope: counting, symmetric and normalize are a float32/int32 "
        "contract. The Haralick features are float64 inside by design "
        "(core.haralick), and only there."
    ),
    check=_check_no_f64_promotion,
))


def _check_stream_signed_accum(ctx: LintContext) -> list[str]:
    out = []
    # (a) The carried state itself: every integer leaf (counts, ring) must
    # be signed — the expiry subtraction transiently dips below the
    # arriving delta, and unsigned arithmetic wraps instead of borrowing.
    for leaf in ctx.state_leaves:
        if _is_unsigned(leaf.dtype):
            out.append(
                f"stream state carries unsigned {leaf.dtype} {tuple(leaf.shape)} — "
                "the expiry subtraction can transiently underflow; rolling "
                "accumulators must be signed (int32)"
            )
    # (b) The recorded step: no count-shaped (…, L, L) subtraction may give
    # an unsigned dtype (single-frame counting never subtracts, so any such
    # subtraction is the rolling expiry running in a wrapping dtype).
    levels = ctx.levels
    for op in ctx.record.ops:
        if not op.name.startswith(("aten.sub", "aten.rsub")) or not op.shapes:
            continue
        shape, dtype = op.shapes[0], op.dtypes[0]
        if len(shape) >= 2 and shape[-2:] == (levels, levels) and _is_unsigned(dtype):
            out.append(
                f"rolling-window {op.name!r} accumulates counts in unsigned "
                f"{dtype} (shape {shape}) — incremental plans must accumulate "
                "in signed integer dtypes"
            )
    return out


register_rule(Rule(
    name="stream-signed-accum",
    description=(
        "An incremental temporal plan must accumulate its rolling-window "
        "counts in SIGNED integer dtypes: the expiry subtraction can "
        "transiently underflow an unsigned width, and the wraparound "
        "silently corrupts every later window."
    ),
    check=_check_stream_signed_accum,
))


def _check_device_kernel_launches(ctx: LintContext) -> list[str]:
    out = []
    # Only the counting kernels: the feature kernels launch for any plan
    # with features, whatever produced the counts.
    features = {k.name for k in _build.TABLE if k.role == "features"}
    n = sum(v for k, v in ctx.record.launches.items() if k not in features)
    if n == 0:
        out.append(
            "CUDA plan of a caps.device_kernel backend launched no kernel — "
            "its counts came from somewhere else than the card's kernels"
        )
    plain = sorted({op.name for op in ctx.record.ops if op.in_kernel})
    if plain:
        out.append(
            f"{len(plain)} op kind(s) ran inside a kernel:* scope on the card "
            f"({', '.join(plain[:6])}) — a plain version stood in for its kernel"
        )
    return out


register_rule(Rule(
    name="device-kernel-launches",
    description=(
        "A CUDA plan of a backend declaring caps.device_kernel must launch "
        "at least one of the card's counting kernels and run no plain version in "
        "their place (no op inside a kernel:* scope): a kernel or raise, "
        "never a quiet fallback."
    ),
    check=_check_device_kernel_launches,
))


# ---------------------------------------------------------------------------
# Plan entry point
# ---------------------------------------------------------------------------


def _leaves(state) -> tuple[torch.Tensor, ...]:
    return tuple(getattr(state, f.name) for f in dataclasses.fields(state))


def lint_plan(plan, *, dtype=None, rules: Iterable[str] | None = None) -> tuple[Finding, ...]:
    """Lint one compiled plan (``GLCMPlan`` or ``GLCMStreamPlan``).

    Records one call of the plan at its compiled shape (``dtype`` defaults
    to :func:`default_input_dtype`), selects the applicable rules from the
    contract layer (or runs exactly ``rules`` when given), and returns a
    tuple of :class:`Finding` — empty means every implied contract is borne
    out by the recorded call."""
    from repro_torch.analysis import contracts  # late: contracts imports this module

    dtype = default_input_dtype(plan.spec) if dtype is None else dtype
    record = record_plan(plan, dtype)
    stream = is_stream_plan(plan)
    ctx = LintContext(
        record=record,
        spec=plan.spec,
        backend=plan.backend,
        shape=plan.shape,
        dtype=dtype,
        features=plan.features,
        fused_quantize=plan.fused_quantize,
        host_native=plan.host_native,
        temporal_window=plan.window if stream else None,
        state_leaves=_leaves(plan.state_struct()) if stream else (),
        device=plan.device,
    )
    names = contracts.applicable_rules(ctx) if rules is None else tuple(rules)
    findings = []
    for name in names:
        rule = get_rule(name)
        findings.extend(ctx.finding(name, msg) for msg in rule.check(ctx))
    return tuple(findings)
