"""Registry audit: record every backend's plans and lint their contracts.

Counterpart of ``repro.analysis.audit``:

    python -m repro_torch.analysis.audit [-v] [--json PATH] [--backend NAME]
        [--case SUBSTRING] [--device cuda|cpu]

sweeps every registered backend across the reference's spec matrix (2-D /
tiles / window / volume / temporal stream × quantize modes × accum modes ×
feature selections, at the reference's shapes), records one call of each
resulting plan on ``--device`` (default the card, like every entry point of
the package) and lints it against the rules the contract layer says the
backend's declared ``Capabilities`` and the spec imply. A declared
capability the recorded call does not bear out fails the audit with a
per-backend, per-rule report. A plan-time ``ValueError`` skips the cell; any
other exception is recorded as an error.

Exit status: 0 when every (backend, case) is clean, 1 when any rule fired or
any cell or self-check errored. ``--json PATH`` writes the full report.

The audit also runs the reference's two recorder self-checks (positive
"dirty" controls), so that a broken recorder cannot make the sweep
vacuously green: the pre-quantize path must *show* the materialized
quantized image the fused rule forbids, and an mcc-selecting plan must
*show* the eigendecomposition the pruning rule forbids. On the card a third
one runs: a scratch backend that claims ``device_kernel`` but counts with a
plain version on the card must fire ``device-kernel-launches``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.analysis import op_lint
from repro_torch.core import backends as _backends
from repro_torch.core.plan import compile_plan, resolve_device
from repro_torch.core.spec import GLCMSpec

__all__ = ["AuditCase", "AuditReport", "audit_cases", "run_audit", "main"]


@dataclasses.dataclass(frozen=True)
class AuditCase:
    """One cell of the spec matrix: a workload every capable backend is
    recorded on. ``dtype`` is the lint input's dtype."""

    name: str
    spec: GLCMSpec
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.int32
    features: bool | tuple[str, ...] = False
    temporal_window: int | None = None  # stream cases: unbatched frame shape


def audit_cases() -> tuple[AuditCase, ...]:
    """The reference's workload matrix, at its shapes: small, with plane
    sizes that never collide with ``levels`` (so the vote-matmul shape test
    stays unambiguous) and tile/blocked divisibility holding for every
    backend's validator."""
    pairs2 = ((1, 0), (1, 45), (2, 90))
    vol_pairs = ((1, 0), (1, 4), (1, 7))
    f32 = torch.float32
    return (
        # -- 2-D global ---------------------------------------------------
        AuditCase("2d/prequantized/int-accum",
                  GLCMSpec(levels=16, pairs=pairs2, accum="int"), (2, 32, 32)),
        AuditCase("2d/prequantized/float-accum",
                  GLCMSpec(levels=16, pairs=pairs2, accum="float32",
                           symmetric=True, normalize=True), (2, 32, 32)),
        AuditCase("2d/fused-uniform",
                  GLCMSpec(levels=16, pairs=pairs2, quantize="uniform"),
                  (2, 40, 36), dtype=f32),
        AuditCase("2d/fused-uniform/int-accum",
                  GLCMSpec(levels=16, pairs=pairs2, quantize="uniform", accum="int"),
                  (2, 40, 36), dtype=f32),
        AuditCase("2d/identity-quantize",
                  GLCMSpec(levels=256, pairs=((1, 0),), quantize="uniform",
                           vrange=(0, 255)), (24, 20), dtype=torch.uint8),
        AuditCase("2d/equalized",
                  GLCMSpec(levels=8, pairs=((1, 0),), quantize="equalized"),
                  (2, 24, 28), dtype=f32),
        # -- region grids -------------------------------------------------
        AuditCase("tiles/fused-uniform",
                  GLCMSpec(levels=8, pairs=((1, 0), (1, 135)), quantize="uniform",
                           region="tiles", region_shape=16), (2, 32, 32), dtype=f32),
        AuditCase("window/int-accum",
                  GLCMSpec(levels=8, pairs=((1, 0),), region="window",
                           region_shape=12, region_stride=8, accum="int"), (2, 28, 28)),
        # -- feature selections -------------------------------------------
        AuditCase("features/pruned",
                  GLCMSpec(levels=16, pairs=((1, 0), (1, 45)), normalize=True),
                  (2, 32, 32), features=("contrast", "entropy", "asm_energy")),
        AuditCase("features/full14",
                  GLCMSpec(levels=8, pairs=((1, 0),), normalize=True), (24, 20),
                  features=True),
        # -- incremental temporal streams ---------------------------------
        AuditCase("stream/fused-uniform",
                  GLCMSpec(levels=16, pairs=pairs2, quantize="uniform"), (40, 36),
                  dtype=f32, temporal_window=8),
        AuditCase("stream/tiles/int-accum",
                  GLCMSpec(levels=8, pairs=((1, 0), (1, 135)), region="tiles",
                           region_shape=16, accum="int"), (32, 32), temporal_window=4),
        # -- volumetric ----------------------------------------------------
        AuditCase("volume/fused-uniform",
                  GLCMSpec(levels=8, pairs=vol_pairs, quantize="uniform", ndim=3),
                  (2, 8, 20, 24), dtype=f32),
        AuditCase("volume/int-accum",
                  GLCMSpec(levels=8, pairs=vol_pairs, accum="int", ndim=3),
                  (2, 8, 20, 24)),
    )


@dataclasses.dataclass
class AuditReport:
    """The audit outcome: per-(backend, case) rule runs and findings."""

    findings: list[op_lint.Finding] = dataclasses.field(default_factory=list)
    checked: list[dict] = dataclasses.field(default_factory=list)
    skipped: list[dict] = dataclasses.field(default_factory=list)
    errors: list[dict] = dataclasses.field(default_factory=list)
    self_checks: list[str] = dataclasses.field(default_factory=list)
    device: str = "cuda"

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_dict(self) -> dict:
        by_backend: dict[str, list] = {}
        for f in self.findings:
            by_backend.setdefault(f.backend, []).append(dataclasses.asdict(f))
        return {
            "ok": self.ok,
            "device": self.device,
            "n_checked": len(self.checked),
            "n_skipped": len(self.skipped),
            "findings_by_backend": by_backend,
            "checked": self.checked,
            "skipped": self.skipped,
            "errors": self.errors,
            "self_checks": self.self_checks,
        }


def _serves(backend: _backends.Backend, case: AuditCase) -> str | None:
    """None when ``backend`` can serve ``case``; else the skip reason."""
    spec = case.spec
    if not _backends.supports_ndim(backend, spec.ndim):
        return f"ndim={spec.ndim} unsupported"
    try:
        resolved = spec.replace(scheme=backend.name)
        if backend.validate is not None and spec.region == "global":
            backend.validate(resolved, case.shape)
    except ValueError as exc:
        return str(exc)
    return None


def run_audit(
    *,
    backends: tuple[str, ...] | None = None,
    cases: tuple[AuditCase, ...] | None = None,
    case_filter: str | None = None,
    device="cuda",
) -> AuditReport:
    """Record and lint every (backend, case) combination of the live
    registry on ``device`` (default the card; raises without one). Each
    checked cell runs its plan once on a small seeded input."""
    dev = resolve_device(device)
    report = AuditReport(device=dev.type)
    names = backends if backends is not None else _backends.available_backends()
    matrix = cases if cases is not None else audit_cases()
    if case_filter:
        matrix = tuple(c for c in matrix if case_filter in c.name)
    for case in matrix:
        for name in names:
            backend = _backends.get_backend(name)
            reason = _serves(backend, case)
            if reason is not None:
                report.skipped.append({"backend": name, "case": case.name, "reason": reason})
                continue
            spec = case.spec.replace(scheme=name)
            try:
                plan = compile_plan(spec, case.shape, features=case.features,
                                    temporal_window=case.temporal_window, device=dev)
                findings = op_lint.lint_plan(plan, dtype=case.dtype)
            except ValueError as exc:
                # Plan-time rejection (shape/capability validation) is the
                # dynamic contract layer doing its job — an audit skip.
                report.skipped.append({"backend": name, "case": case.name, "reason": str(exc)})
                continue
            except Exception as exc:  # noqa: BLE001 — an audit must not die
                report.errors.append({"backend": name, "case": case.name,
                                      "error": f"{type(exc).__name__}: {exc}"})
                continue
            report.findings.extend(findings)
            report.checked.append({"backend": name, "case": case.name,
                                   "rules": list(_rules_run(plan, case)),
                                   "clean": not findings})
    _recorder_self_checks(report, dev)
    return report


def _rules_run(plan, case: AuditCase) -> tuple[str, ...]:
    from repro_torch.analysis import contracts

    ctx = op_lint.LintContext(
        record=None, spec=plan.spec, backend=plan.backend, shape=plan.shape,
        dtype=case.dtype, features=plan.features, fused_quantize=plan.fused_quantize,
        host_native=plan.host_native, temporal_window=case.temporal_window,
        device=plan.device,
    )
    return contracts.applicable_rules(ctx)


PLAIN_ON_CARD = "_audit_plain_on_card"


def _plain_on_card(img: torch.Tensor, spec: GLCMSpec, quant=None) -> torch.Tensor:
    """Counts by the fused kernel's plain version, whatever the device: what
    a backend that falls back quietly on the card would do."""
    from repro_torch.kernels.glcm_kernel import glcm_fused_plain

    return glcm_fused_plain(img, spec.levels, spec.offsets(), quant=quant).to(torch.float32)


def _recorder_self_checks(report: AuditReport, dev: torch.device) -> None:
    """Positive "dirty" controls: plans that MUST trip the recorder.

    If the recorder silently broke (an op renamed in a PyTorch upgrade, a
    scope that stopped being entered), every rule above would pass
    vacuously — these checks fail the audit instead."""
    def fail(backend: str, case: str, error: str) -> None:
        report.errors.append({"backend": backend, "case": case, "error": error})

    # 1. The pre-quantize path (blocked lacks fused_quantize) DOES
    #    materialize the quantized image; the recorder must see it.
    spec = GLCMSpec(levels=16, pairs=((1, 0),), quantize="uniform", scheme="blocked")
    plan = compile_plan(spec, (2, 32, 32), device=dev)
    if op_lint.int_image_ops(op_lint.record_plan(plan, torch.float32), (32, 32)):
        report.self_checks.append("dirty-int-image")
    else:
        fail("blocked", "self-check/dirty-int-image",
             "recorder missed the materialized quantized image the pre-quantize "
             "path is known to produce")
    # 2. Selecting max_correlation_coefficient must SHOW the eigh the
    #    pruning rule forbids elsewhere (on the card: f14's kernel launch).
    spec = GLCMSpec(levels=8, pairs=((1, 0),), normalize=True, scheme="onehot")
    plan = compile_plan(spec, (24, 20), features=("max_correlation_coefficient",), device=dev)
    if op_lint.eigh_ops(op_lint.record_plan(plan, torch.int32)):
        report.self_checks.append("dirty-eigh")
    else:
        fail("onehot", "self-check/dirty-eigh",
             "recorder missed the eigendecomposition an mcc-selecting plan is "
             "known to contain")
    # 3. On the card: a backend claiming device_kernel that counts with a
    #    plain version must fire device-kernel-launches.
    if dev.type != "cuda":
        return
    _backends.register(_backends.Backend(
        name=PLAIN_ON_CARD, compute=_plain_on_card,
        caps=_backends.Capabilities(multi_offset_fused=True, fused_quantize=True,
                                    device_kernel=True),
    ))
    try:
        spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform",
                        scheme=PLAIN_ON_CARD)
        plan = compile_plan(spec, (2, 32, 32), device=dev)
        rules = {f.rule for f in op_lint.lint_plan(plan)}
    finally:
        _backends.unregister(PLAIN_ON_CARD)
    if "device-kernel-launches" in rules:
        report.self_checks.append("dirty-plain-on-card")
    else:
        fail(PLAIN_ON_CARD, "self-check/dirty-plain-on-card",
             f"a plain version on the card fired {sorted(rules)}, not "
             "device-kernel-launches")


def _print_report(report: AuditReport, *, verbose: bool = False) -> None:
    print(
        f"plan-contract audit ({report.device}): {len(report.checked)} (backend, case) "
        f"plans recorded, {len(report.skipped)} skipped, {len(report.findings)} "
        f"finding(s), {len(report.errors)} error(s), self-checks fired: "
        f"{', '.join(report.self_checks) or 'none'}"
    )
    if verbose:
        for row in report.checked:
            state = "ok " if row["clean"] else "FAIL"
            print(f"  {state} {row['backend']:<14} {row['case']:<28} "
                  f"rules: {', '.join(row['rules'])}")
        for row in report.skipped:
            print(f"  skip {row['backend']:<14} {row['case']:<28} ({row['reason']})")
    for f in report.findings:
        print(f"  FINDING {f}")
    for row in report.errors:
        print(f"  ERROR {row['backend']} / {row['case']}: {row['error']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=(
            "Audit every registered GLCM backend's declared capabilities "
            "against one recorded call of each of its plans."
        )
    )
    ap.add_argument("--backend", action="append", default=None,
                    help="audit only this backend (repeatable)")
    ap.add_argument("--case", default=None,
                    help="audit only cases whose name contains this substring")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the plans run (default: the card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    report = run_audit(
        backends=tuple(args.backend) if args.backend else None,
        case_filter=args.case,
        device=args.device,
    )
    _print_report(report, verbose=args.verbose)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_dict(), fh, indent=1, sort_keys=True)
        print(f"report -> {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
