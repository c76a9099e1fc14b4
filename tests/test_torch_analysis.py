"""The port's plan-contract analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

Counterparts of ``tests/test_analysis.py``: every lint rule must FIRE on a
deliberately broken backend (one per rule, the port's own
``device-kernel-launches`` included), the live registry must audit clean
and check and skip the same (backend, case) cells as the reference's audit,
the capability→rule classification must be total and decide as the
reference's does, and ``compile_plan``'s ``check="lint"`` /
``REPRO_PLAN_LINT=1`` must enforce the verdict for batch and temporal plans.
Besides: recorder units (scopes, the kernel boundary, views of the input),
``state_struct`` against the reference's, and the one-hot schemes' integer
votes under ``accum="int"`` bit for bit against the reference's counts.

The port lints one recorded call of a plan where the reference traces
abstractly, so every plan here runs once on a small seeded input.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import audit, contracts, op_lint  # noqa: E402
from repro_torch.analysis.scopes import recording, scope  # noqa: E402
from repro_torch.core import backends as _backends  # noqa: E402
from repro_torch.core import schemes as _schemes  # noqa: E402
from repro_torch.core.plan import compile_plan, plan_cache_clear  # noqa: E402
from repro_torch.core.quantize import bin_values  # noqa: E402
from repro_torch.core.schemes import glcm_multi, glcm_scatter_batch  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.analysis import audit as ref_audit
    from repro.core.plan import compile_plan as ref_compile_plan
except ImportError:
    ref_audit = None

needs_ref = pytest.mark.skipif(ref_audit is None, reason="the JAX reference is not installed")

CPU = "cpu"
# Backend names of the reference's registry → the port's.
PORT_NAME = {"pallas": "cuda", "pallas_fused": "cuda_fused", "pallas_volume": "cuda_volume"}


@pytest.fixture
def scratch():
    """Register throwaway backends; guarantee they never leak past the test
    (they would poison registry sweeps and "auto" resolution)."""
    names = []

    def add(backend):
        _backends.register(backend)
        names.append(backend.name)
        return backend

    plan_cache_clear()
    yield add
    for name in names:
        _backends.unregister(name)
    plan_cache_clear()


def _delegate(img, spec, quant=None):
    return glcm_scatter_batch(img, spec.levels, spec.offsets(), quant=quant).to(torch.float32)


def _lint(scheme, spec, shape, *, dtype=None, features=False, rules=None):
    plan = compile_plan(spec.replace(scheme=scheme), shape, features=features, device=CPU)
    return op_lint.lint_plan(plan, dtype=dtype, rules=rules)


def _rules_fired(findings):
    return {f.rule for f in findings}


def _host_trip(img, spec, quant=None):
    """A device backend (no host_native cap) that round-trips to the host."""
    with scope("host"):
        x = img.cpu().numpy()
        out = np.zeros((x.shape[0], spec.n_pairs, spec.levels, spec.levels), np.float32)
        return torch.from_numpy(out).to(img.device)


# ---------------------------------------------------------------------------
# One deliberately broken backend per rule
# ---------------------------------------------------------------------------


def test_fires_fused_no_int_image(scratch):
    """Claims fused_quantize but bins the whole image before counting."""

    def eager(img, spec, quant=None):
        if quant is not None:
            lo, span = (q.reshape(-1, 1, 1) if torch.is_tensor(q) else q for q in quant)
            img = bin_values(img, spec.levels, lo, span)  # (B, H, W) int32
        return _delegate(img, spec)

    scratch(_backends.Backend(name="_lint_eager", compute=eager,
                              caps=_backends.Capabilities(fused_quantize=True)))
    spec = GLCMSpec(levels=16, pairs=((1, 0),), quantize="uniform")
    findings = _lint("_lint_eager", spec, (2, 32, 32), dtype=torch.float32)
    assert "fused-no-int-image" in _rules_fired(findings)


def test_fires_identity_quantize_float_free(scratch):
    """Reintroduces floor/div binning on a provably-identity workload."""

    def rebinner(img, spec, quant=None):
        img = torch.floor(img.to(torch.float32) / 1.0).to(torch.int32)
        return _delegate(img, spec, quant=quant)

    scratch(_backends.Backend(name="_lint_rebin", compute=rebinner,
                              caps=_backends.Capabilities(fused_quantize=True)))
    spec = GLCMSpec(levels=256, pairs=((1, 0),), quantize="uniform", vrange=(0, 255))
    findings = _lint("_lint_rebin", spec, (24, 20), dtype=torch.uint8)
    assert "identity-quantize-float-free" in _rules_fired(findings)


def test_fires_accum_exact_width(scratch):
    """Votes in float32 despite the spec demanding exact integer accum (the
    one-hot schemes before they honoured accum="int")."""

    def float_votes(img, spec, quant=None):
        return glcm_multi(img, spec.levels, offsets=spec.offsets(), quant=quant)

    scratch(_backends.Backend(name="_lint_f32votes", compute=float_votes,
                              caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=16, pairs=((1, 0),), accum="int")
    findings = _lint("_lint_f32votes", spec, (2, 32, 32))
    assert "accum-exact-width" in _rules_fired(findings)
    assert any("aten.bmm" in f.message for f in findings)


def test_fires_no_host_callback(scratch):
    """A device backend (no host_native cap) whose counts take a round trip
    through the host scope."""
    scratch(_backends.Backend(name="_lint_callback", compute=_host_trip,
                              caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    findings = _lint("_lint_callback", spec, (2, 16, 16))
    assert "no-host-callback" in _rules_fired(findings)
    # ...while the host-native backend must make exactly one such trip.
    assert not _lint("native", spec, (2, 16, 16))


def test_fires_pruned_no_eigh(scratch):
    """Smuggles an eigendecomposition into a plan that selected none."""

    def eigy(img, spec, quant=None):
        counts = _delegate(img, spec, quant=quant)
        w = torch.linalg.eigvalsh(torch.eye(spec.levels, dtype=torch.float32))
        return counts + 0.0 * w.sum()

    scratch(_backends.Backend(name="_lint_eigh", compute=eigy,
                              caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    findings = _lint("_lint_eigh", spec, (2, 16, 16))
    assert "pruned-no-eigh" in _rules_fired(findings)


def test_pruned_no_eigh_counts_the_eigensolver_kernel():
    """On the card f14's eigensolver kernel leaves no eigh op behind: a
    record with its launch and no op shows an eigendecomposition to the rule
    (and to the audit's ``dirty-eigh`` check, through ``eigh_ops``)."""
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    idle = {k.name: 0 for k in build.TABLE}
    rule = op_lint.get_rule("pruned-no-eigh")

    def check(launches):
        record = op_lint.PlanRecord(ops=(), launches=launches, entered=())
        ctx = op_lint.LintContext(record=record, spec=spec,
                                  backend=_backends.get_backend("cuda_fused"),
                                  shape=(2, 16, 16), dtype=torch.float32,
                                  device=torch.device("cuda"))
        return op_lint.eigh_ops(record), rule.check(ctx)

    assert check(idle) == ([], [])
    found, findings = check({**idle, "glcm_fused": 1, "second_eigenvalue": 1})
    assert found == ["kernel:second_eigenvalue"]
    assert len(findings) == 1 and "kernel:second_eigenvalue" in findings[0]


def test_fires_no_f64_promotion(scratch):
    """Promotes the counts through float64 in the counting stage."""

    def wide(img, spec, quant=None):
        counts = _delegate(img, spec, quant=quant)
        return counts.to(torch.float64).to(torch.float32)

    scratch(_backends.Backend(name="_lint_f64", compute=wide, caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    findings = _lint("_lint_f64", spec, (2, 16, 16))
    assert "no-f64-promotion" in _rules_fired(findings)


@pytest.mark.parametrize("where,fires", [("tail", False), ("counting", True)])
def test_no_f64_promotion_is_scoped_out_of_the_tail(scratch, where, fires):
    """The same float64 round trip fires in the counting stage and not inside
    the ``tail`` scope, where the port's Haralick features are float64 by
    design — and the shipped full-14 features plan is clean."""

    def wide(img, spec, quant=None):
        counts = _delegate(img, spec, quant=quant)
        if where == "tail":
            with scope("tail"):
                return counts.to(torch.float64).to(torch.float32)
        return counts.to(torch.float64).to(torch.float32)

    scratch(_backends.Backend(name="_lint_f64_where", compute=wide,
                              caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    findings = _lint("_lint_f64_where", spec, (2, 16, 16))
    assert ("no-f64-promotion" in _rules_fired(findings)) is fires
    rec = op_lint.record_plan(compile_plan(spec.replace(scheme="onehot"), (2, 16, 16),
                                           features=True, device=CPU))
    f64 = [op for op in rec.ops if torch.float64 in op.dtypes]
    assert f64 and all(op.in_scope("tail") for op in f64)


def test_fires_stream_signed_accum():
    """A rolling update carried in uint8: both the state-leaf probe and the
    wrapping expiry-subtraction probe must fire."""
    levels, window = 8, 4
    cell = (1, levels, levels)

    def bad_update(counts, ring, pos, delta):
        expired = ring[pos]
        counts = counts + delta - expired  # uint8: wraps instead of borrowing
        ring[pos] = delta
        return counts, ring, (pos + 1) % window

    counts = torch.zeros(cell, dtype=torch.uint8)
    ring = torch.zeros((window, *cell), dtype=torch.uint8)
    delta = torch.ones(cell, dtype=torch.uint8)
    rec = op_lint.record_call(bad_update, counts, ring, 0, delta)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    ctx = op_lint.LintContext(
        record=rec,
        spec=GLCMSpec(levels=levels, pairs=((1, 0),), scheme="onehot"),
        backend=_backends.get_backend("onehot"),
        shape=(16, 16),
        dtype=torch.int32,
        temporal_window=window,
        state_leaves=(meta(cell, torch.uint8), meta((window, *cell), torch.uint8),
                      meta((), torch.int32)),
    )
    msgs = op_lint.get_rule("stream-signed-accum").check(ctx)
    assert any("unsigned" in m and "state" in m for m in msgs)
    assert any("aten.sub" in m for m in msgs)


def test_fires_device_kernel_launches():
    """A plain version standing in for its kernel: no launch, and ops inside
    a kernel scope. On the CPU that is by design (so the rule applies only
    to CUDA plans); run explicitly, the rule fires on both counts."""
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform")
    findings = _lint("cuda_fused", spec, (2, 32, 32), rules=["device-kernel-launches"])
    msgs = [f.message for f in findings]
    assert _rules_fired(findings) == {"device-kernel-launches"}
    assert any("launched no kernel" in m for m in msgs)
    assert any("kernel:* scope" in m and "aten.bincount" in m for m in msgs)
    clean = dataclasses.replace(
        _ctx(spec.replace(scheme="cuda_fused"), "cuda"),
        record=op_lint.PlanRecord(ops=(), launches={"glcm_fused": 1}),
    )
    assert op_lint.get_rule("device-kernel-launches").check(clean) == []


def test_device_kernel_launches_ignores_the_eigensolver():
    """f14's eigensolver launches for any plan that selects it, so its launch
    alone does not show that the counts came from the card's kernels."""
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="cuda_fused")
    launches = {k.name: 0 for k in build.TABLE}
    launches["second_eigenvalue"] = 1
    ctx = dataclasses.replace(
        _ctx(spec, "cuda"), record=op_lint.PlanRecord(ops=(), launches=launches))
    msgs = op_lint.get_rule("device-kernel-launches").check(ctx)
    assert len(msgs) == 1 and "launched no kernel" in msgs[0]


def _ctx(spec, device, **kw):
    return op_lint.LintContext(
        record=None, spec=spec, backend=_backends.get_backend(spec.scheme),
        shape=(16, 16), dtype=torch.int32, device=torch.device(device), **kw)


def test_device_kernel_rule_applies_only_on_card():
    for scheme in ("cuda", "cuda_fused"):
        spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme=scheme)
        assert "device-kernel-launches" not in contracts.applicable_rules(_ctx(spec, "cpu"))
        assert "device-kernel-launches" in contracts.applicable_rules(_ctx(spec, "cuda"))
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="onehot")
    assert "device-kernel-launches" not in contracts.applicable_rules(_ctx(spec, "cuda"))


def test_stream_rule_applies_only_to_temporal_plans():
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="onehot")
    assert "stream-signed-accum" not in contracts.applicable_rules(_ctx(spec, "cpu"))
    assert "stream-signed-accum" in contracts.applicable_rules(
        _ctx(spec, "cpu", temporal_window=4))


def test_stream_plan_lints_clean():
    """The shipped incremental plan (signed int32 state by construction)
    survives its own rule, recorded as one update step."""
    plan_cache_clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="onehot")
    plan = compile_plan(spec, (16, 16), temporal_window=3, device=CPU)
    assert op_lint.is_stream_plan(plan)
    assert not op_lint.is_stream_plan(compile_plan(spec, (16, 16), device=CPU))
    assert op_lint.lint_plan(plan) == ()
    assert op_lint.has_op(op_lint.record_plan(plan), "aten.sub_")


# ---------------------------------------------------------------------------
# Contract and audit parity with the reference
# ---------------------------------------------------------------------------


def _port_case(name: str) -> audit.AuditCase:
    return next(c for c in audit.audit_cases() if c.name == name)


@needs_ref
@pytest.mark.parametrize("case_name", [c.name for c in audit.audit_cases()])
def test_contract_parity(case_name):
    """For every cell both audits check, the port's rules on the CPU are the
    reference's for the name-mapped backend."""
    ref_case = next(c for c in ref_audit.audit_cases() if c.name == case_name)
    case = _port_case(case_name)
    assert case.shape == ref_case.shape and case.features == ref_case.features
    assert str(case.dtype).removeprefix("torch.") == str(jnp.dtype(ref_case.dtype))
    compared = 0
    for ref_name in ref_audit._backends.available_backends():
        name = PORT_NAME.get(ref_name, ref_name)
        ref_backend = ref_audit._backends.get_backend(ref_name)
        if ref_audit._serves(ref_backend, ref_case) is not None:
            assert audit._serves(_backends.get_backend(name), case) is not None
            continue
        ref_plan = ref_compile_plan(
            ref_case.spec.replace(scheme=ref_name), ref_case.shape,
            features=ref_case.features, temporal_window=ref_case.temporal_window)
        plan = compile_plan(case.spec.replace(scheme=name), case.shape,
                            features=case.features, temporal_window=case.temporal_window,
                            device=CPU)
        assert audit._rules_run(plan, case) == ref_audit._rules_run(ref_plan, ref_case), name
        compared += 1
    assert compared >= 5


@needs_ref
def test_audit_parity_with_reference():
    """The CPU audit is clean, both self-checks fire, and it checks and skips
    exactly the reference's (name-mapped) cells: no cell differs."""
    report = audit.run_audit(device=CPU)
    assert report.checked, "audit recorded nothing — the sweep is vacuous"
    assert report.ok, report.to_dict()
    assert report.self_checks == ["dirty-int-image", "dirty-eigh"]
    ref = ref_audit.run_audit()
    assert ref.ok

    def cells(rows, mapped):
        return {(PORT_NAME.get(r["backend"], r["backend"]) if mapped else r["backend"],
                 r["case"]) for r in rows}

    assert cells(report.checked, False) == cells(ref.checked, True)
    assert cells(report.skipped, False) == cells(ref.skipped, True)
    assert (len(report.checked), len(report.skipped)) == (len(ref.checked), len(ref.skipped))


def test_audit_cli_fails_on_seeded_violation(scratch, capsys, tmp_path):
    """End-to-end CLI: exit 0 on the clean registry, exit 1 naming the
    backend and rule once a violating backend is registered; ``--json``
    writes the report."""
    args = ["--case", "2d/prequantized/int-accum", "--device", CPU]
    assert audit.main(args) == 0
    scratch(_backends.Backend(name="_lint_cli_bad", compute=_host_trip,
                              caps=_backends.Capabilities()))
    path = tmp_path / "audit.json"
    assert audit.main(args + ["--json", str(path)]) == 1
    out = capsys.readouterr().out
    assert "_lint_cli_bad" in out and "no-host-callback" in out
    report = json.loads(path.read_text())
    assert not report["ok"] and report["device"] == CPU
    assert [f["rule"] for f in report["findings_by_backend"]["_lint_cli_bad"]] == [
        "no-host-callback"]
    assert report["n_checked"] == 7 and report["n_skipped"] == 1


def test_audit_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audit.run_audit(case_filter="2d/equalized")


# ---------------------------------------------------------------------------
# Contract classification totality
# ---------------------------------------------------------------------------


def test_capability_classification_is_total():
    """Every Capabilities field is classified exactly once — adding a field
    without deciding how it is audited must fail here."""
    fields = {f.name for f in dataclasses.fields(_backends.Capabilities)}
    traced = set(contracts.CAPABILITY_RULES)
    dynamic = set(contracts.DYNAMIC_CAPABILITIES)
    assert traced | dynamic == fields
    assert not traced & dynamic


def test_contract_rules_are_registered():
    names = set(op_lint.registered_rules())
    for rules in contracts.CAPABILITY_RULES.values():
        assert set(rules) <= names
    assert set(contracts.SPEC_RULES.values()) <= names
    assert len(names) == 8


def test_rule_registry_rejects_duplicates_and_unknowns():
    with pytest.raises(ValueError, match="already registered"):
        op_lint.register_rule(op_lint.get_rule("pruned-no-eigh"))
    with pytest.raises(ValueError, match="unknown lint rule"):
        op_lint.get_rule("no-such-rule")


# ---------------------------------------------------------------------------
# compile_plan(check="lint") / REPRO_PLAN_LINT
# ---------------------------------------------------------------------------


def test_check_lint_passes_and_caches_verdict():
    plan_cache_clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),), quantize="uniform", scheme="onehot")
    plan = compile_plan(spec, (2, 16, 16), check="lint", device=CPU)
    assert plan.lint == ()
    # the verdict rides the cache entry: a later unchecked lookup sees it, and
    # a plan compiled WITHOUT check is linted on its first linted hit
    assert compile_plan(spec, (2, 16, 16), device=CPU).lint == ()
    plan_cache_clear()
    cold = compile_plan(spec, (2, 16, 16), device=CPU)
    assert cold.lint is None
    assert compile_plan(spec, (2, 16, 16), check="lint", device=CPU) is cold
    assert cold.lint == ()


def test_check_lint_raises_on_violation(scratch):
    scratch(_backends.Backend(name="_lint_gate_bad", compute=_host_trip,
                              caps=_backends.Capabilities()))
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="_lint_gate_bad")
    with pytest.raises(op_lint.PlanContractError, match="no-host-callback"):
        compile_plan(spec, (2, 16, 16), check="lint", device=CPU)
    # the recorded verdict keeps failing on every later linted lookup
    with pytest.raises(op_lint.PlanContractError):
        compile_plan(spec, (2, 16, 16), check="lint", device=CPU)
    # ...but an unchecked lookup still serves the plan (opt-in enforcement)
    assert compile_plan(spec, (2, 16, 16), device=CPU).lint


def test_env_var_enables_lint(monkeypatch):
    plan_cache_clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),), scheme="scatter")
    monkeypatch.setenv("REPRO_PLAN_LINT", "1")
    assert compile_plan(spec, (2, 16, 16), device=CPU).lint == ()
    # check="" opts a single call back out even with the env var set
    plan_cache_clear()
    assert compile_plan(spec, (2, 16, 16), check="", device=CPU).lint is None
    with pytest.raises(ValueError, match="unknown check mode"):
        compile_plan(spec, (2, 16, 16), check="bogus", device=CPU)


def test_check_lint_temporal_plans(scratch, monkeypatch):
    """Temporal plans lint like batch plans: a clean verdict is cached on
    the stream plan, the env var turns it on, and a violating backend's
    stream plan raises."""
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform", scheme="onehot")
    plan = compile_plan(spec, (16, 16), temporal_window=3, check="lint", device=CPU)
    assert plan.lint == ()
    assert compile_plan(spec, (16, 16), temporal_window=3, device=CPU) is plan
    monkeypatch.setenv("REPRO_PLAN_LINT", "1")
    assert compile_plan(spec, (16, 16), temporal_window=5, device=CPU).lint == ()
    monkeypatch.delenv("REPRO_PLAN_LINT")
    scratch(_backends.Backend(name="_lint_stream_bad", compute=_host_trip,
                              caps=_backends.Capabilities()))
    with pytest.raises(op_lint.PlanContractError, match="no-host-callback"):
        compile_plan(spec.replace(scheme="_lint_stream_bad"), (16, 16), temporal_window=3,
                     check="lint", device=CPU)


# ---------------------------------------------------------------------------
# Recorder units
# ---------------------------------------------------------------------------


def test_recorder_records_nested_ops_and_scopes():
    """Ops of nested calls are recorded with the scopes open around them,
    outermost first; entered scopes are counted in order; ``.item()`` is a
    scalar read (``aten._local_scalar_dense``)."""

    def inner(x):
        with scope("kernel:demo"):
            return torch.bincount(x.reshape(-1).to(torch.int64), minlength=4)

    def outer(x):
        with scope("tail"):
            counts = inner(x)
            w = torch.linalg.eigvalsh(torch.eye(3, dtype=torch.float64)[None])
        return counts.sum().item() + w.sum()

    x = torch.randint(0, 4, (5, 6), dtype=torch.int32)
    rec = op_lint.record_call(outer, x, inputs=[x])
    names = op_lint.op_names(rec)
    assert {"aten.bincount", "aten._linalg_eigh", "aten._local_scalar_dense"} <= names
    by_name = {op.name: op for op in rec.ops}
    assert by_name["aten.bincount"].scopes == ("tail", "kernel:demo")
    assert by_name["aten.bincount"].in_kernel
    assert by_name["aten._linalg_eigh"].scopes == ("tail",)
    assert by_name["aten._local_scalar_dense"].scopes == ()
    assert rec.entered == ("tail", "kernel:demo")
    assert set(rec.launches.values()) == {0}


def test_scopes_are_free_without_a_recording():
    with scope("host") as s:
        assert s is None  # the shared no-op context
    with recording() as rec:
        with scope("host"):
            assert rec.stack == ["host"]
        with pytest.raises(RuntimeError, match="already active"):
            with recording():
                pass
    assert rec.entered == ["host"] and rec.stack == []


def test_int_image_ops_stop_at_kernel_scope():
    """A plain version's full-extent integer binning inside a kernel scope
    stands for a kernel's on-chip block, not a materialized image: hidden
    from ``int_image_ops``, present in ``op_names`` (the counterpart of the
    reference's ``pallas_call`` boundary test)."""
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 4)), quantize="uniform",
                    scheme="cuda_volume", ndim=3)
    plan = compile_plan(spec, (2, 8, 20, 24), device=CPU)
    rec = op_lint.record_plan(plan, torch.float32)
    assert op_lint.int_image_ops(rec, (8, 20, 24)) == []
    assert "aten.bincount" in op_lint.op_names(rec)
    assert all(op.in_kernel for op in rec.ops if op.name == "aten.bincount")

    vol = torch.rand((2, 8, 20, 24))

    def bins_whole_volume(v, inside):
        if inside:
            with scope("kernel:glcm_volume"):
                return bin_values(v, 8, 0.0, 1.0)
        return bin_values(v, 8, 0.0, 1.0)

    hidden = op_lint.record_call(bins_whole_volume, vol, True, inputs=[vol])
    shown = op_lint.record_call(bins_whole_volume, vol, False, inputs=[vol])
    assert op_lint.int_image_ops(hidden, (8, 20, 24)) == []
    assert "aten.floor_" in op_lint.op_names(hidden)
    assert op_lint.int_image_ops(shown, (8, 20, 24)) == [
        ("aten._to_copy", (2, 8, 20, 24), "torch.int32")]


def test_int_image_ops_skip_views_of_the_input():
    """A view of a uint8 input is the input, not a derived image; a widened
    copy of it is an integer image."""
    x = torch.randint(0, 256, (2, 24, 20), dtype=torch.uint8)
    views = op_lint.record_call(lambda t: t[None].reshape(2, 24, 20)[:, :, :], x, inputs=[x])
    assert views.ops and all(op.aliases_input for op in views.ops)
    assert op_lint.int_image_ops(views, (24, 20)) == []
    copy = op_lint.record_call(lambda t: t.to(torch.int32), x, inputs=[x])
    assert op_lint.int_image_ops(copy, (24, 20)) == [
        ("aten._to_copy", (2, 24, 20), "torch.int32")]


# ---------------------------------------------------------------------------
# state_struct
# ---------------------------------------------------------------------------


@needs_ref
@pytest.mark.parametrize("case_name", ["stream/fused-uniform", "stream/tiles/int-accum"])
def test_state_struct_matches_reference(case_name):
    case = _port_case(case_name)
    ref_case = next(c for c in ref_audit.audit_cases() if c.name == case_name)
    plan = compile_plan(case.spec.replace(scheme="onehot"), case.shape,
                        temporal_window=case.temporal_window, device=CPU)
    ref_plan = ref_compile_plan(ref_case.spec.replace(scheme="onehot"), ref_case.shape,
                                temporal_window=ref_case.temporal_window)
    got, want = plan.state_struct(), ref_plan.state_struct()
    for field in ("counts", "ring", "pos", "seen"):
        t, r = getattr(got, field), getattr(want, field)
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(r.shape), field
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), field
    state = plan.init_state()
    for field in ("counts", "ring", "pos", "seen"):
        assert getattr(state, field).shape == getattr(got, field).shape


# ---------------------------------------------------------------------------
# Integer votes under accum="int"
# ---------------------------------------------------------------------------


@needs_ref
@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("scheme", ["onehot", "blocked"])
@pytest.mark.parametrize("case_name", ["2d/prequantized/int-accum", "window/int-accum"])
def test_int_votes_match_reference(case_name, scheme, copies):
    """The one-hot schemes under accum="int" vote in integers (int32 on the
    CPU) and count bit for bit as the reference does, on its audit specs,
    and the recorded call holds no float vote matmul."""
    case = _port_case(case_name)
    ref_case = next(c for c in ref_audit.audit_cases() if c.name == case_name)
    rng = np.random.default_rng(19)
    img = rng.integers(0, case.spec.levels, case.shape).astype(np.int32)
    img[0, 0, :3] = -1  # pads never vote
    spec = case.spec.replace(scheme=scheme, copies=copies)
    plan = compile_plan(spec, case.shape, device=CPU)
    ref_plan = ref_compile_plan(ref_case.spec.replace(scheme=scheme, copies=copies),
                                ref_case.shape)
    got = plan(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_plan(jnp.asarray(img))))
    scatter = compile_plan(spec.replace(scheme="scatter"), case.shape, device=CPU)
    np.testing.assert_array_equal(got, scatter(torch.from_numpy(img)).numpy())
    assert op_lint.lint_plan(plan) == ()
    rec = op_lint.record_plan(plan)
    assert any(op.name == "aten.bmm" and op.dtypes == (torch.int32,) for op in rec.ops)


@pytest.mark.parametrize("levels,pairs", [(2, 1), (8, 13), (17, 64), (32, 200)])
def test_int_mm_votes_equal_einsum(levels, pairs):
    """The card's integer vote route (int8 one-hots through ``torch._int_mm``,
    padded to its shape rules) against the int32 einsum, run on the CPU."""
    gen = torch.Generator().manual_seed(levels * 1000 + pairs)
    r = torch.randint(-1, levels, (3, pairs), generator=gen)
    a = torch.randint(-1, levels, (3, pairs), generator=gen)
    want = _schemes._votes(_schemes._onehot(r, levels, torch.int32),
                           _schemes._onehot(a, levels, torch.int32))
    got = _schemes._int_mm_votes(_schemes._onehot(r, levels, torch.int8),
                                 _schemes._onehot(a, levels, torch.int8))
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert _schemes._vote_dtype(True, torch.device("cuda")) == torch.int8
    assert _schemes._vote_dtype(True, torch.device("cpu")) == torch.int32
    assert _schemes._vote_dtype(False, torch.device("cuda")) == torch.float32


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_audit_on_card():
    """The registry audits clean on the card, with all three self-checks
    firing (the third: a plain version on the card trips
    ``device-kernel-launches``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    report = audit.run_audit(device="cuda")
    assert report.checked and report.ok, report.to_dict()
    assert report.self_checks == ["dirty-int-image", "dirty-eigh", "dirty-plain-on-card"]
    assert "_audit_plain_on_card" not in _backends.available_backends()
