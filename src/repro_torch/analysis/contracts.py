"""Capability → rule contracts: what each declared capability must prove.

Counterpart of ``repro.analysis.contracts``, with the same decisions over
the port's ``core.backends.Capabilities``. Capabilities are *declared, not
probed*: a backend can claim ``fused_quantize=True`` while materializing the
quantized image, or ``device_kernel=True`` while computing its counts with a
plain version on the card, and nothing in the execution layer would notice.
This module maps every ``Capabilities`` field to the lint rules
(:mod:`repro_torch.analysis.op_lint`) that verify the claim against the
recorded call, and every spec-level guarantee (``accum="int"`` exactness,
``select=`` pruning, the float32/int32 dtype contract, signed rolling
counts) to the rule enforcing it.

The dtype contract is the port's own where it differs from the reference:
count-only results (``glcm()``, a plan or a stream without normalize or
features, and the engine's results for them) are exact int32 counts, where
the reference's are float32 and round a cell past 2²⁴. Normalized matrices
and features are float32 in both; only the Haralick tail is float64.

Every field of ``Capabilities`` is classified here in exactly one of:

* :data:`CAPABILITY_RULES` — fields whose claim is an observable property
  of the recorded call, mapped to the enforcing rule names (conditioned on
  the spec configurations and the device under which it is observable);
* :data:`DYNAMIC_CAPABILITIES` — fields whose claim is enforced at plan or
  registry time (shape validation, dispatch routing, registration
  invariants) and leaves no footprint in a record, with the reason.

``tests/test_torch_analysis.py`` asserts the classification is total.

:func:`applicable_rules` is the single decision point ``lint_plan`` and the
audit CLI consult.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.op_lint import LintContext
from repro_torch.core.quantize import is_identity_quantize

__all__ = [
    "CAPABILITY_RULES",
    "DYNAMIC_CAPABILITIES",
    "SPEC_RULES",
    "applicable_rules",
]


# Capability fields whose declaration implies a property observable in a
# recorded call, mapped to the rule names that enforce it. The rules still
# gate on the configuration making the property observable (see
# ``applicable_rules``): fused quantization only in a quantize="uniform"
# plan, the identity short-circuit only with a uint8 levels=256
# vrange=(0, 255) workload, the exactly-one-round-trip contract only in the
# host-native backend's plan, kernel launches only on the card.
CAPABILITY_RULES: dict[str, tuple[str, ...]] = {
    "fused_quantize": ("fused-no-int-image", "identity-quantize-float-free"),
    "host_native": ("no-host-callback",),
    "device_kernel": ("device-kernel-launches",),
}

# Capability fields with no footprint in a recorded call: their claims are
# enforced dynamically (plan-time validation, dispatch routing, register()
# invariants), so no lint rule can — or needs to — audit them.
DYNAMIC_CAPABILITIES: dict[str, str] = {
    "multi_offset_fused": (
        "a dispatch-granularity claim (all offsets served by ONE pass); a "
        "recorded call shows the launches, not how many offsets each served"
    ),
    "batch_grid": (
        "a kernel-launch topology claim (batch rides the kernel grid); "
        "enforced by the kernel's grid construction, invisible to an op "
        "record, which sees a ctypes launch as no op at all"
    ),
    "sharded_partial": (
        "presence of the local_partial hook, consumed by the distributed "
        "layer; enforced at register()/glcm_sharded dispatch time"
    ),
    "region_grid": (
        "presence of the region_compute hook; register() enforces the "
        "cap↔hook pairing and compute_regions routes on it"
    ),
    "volumetric": (
        "a shape-domain claim (serves ndim=3 specs); enforced before any "
        "run by supports_ndim in compile_plan"
    ),
    "volume_only": (
        "a shape-domain claim (serves ONLY ndim=3 specs); enforced before "
        "any run by supports_ndim in compile_plan"
    ),
}

# Spec-level execution guarantees (independent of any capability), mapped
# to their enforcing rule. Conditions live in ``applicable_rules``.
SPEC_RULES: dict[str, str] = {
    "accum='int' exact integer accumulation": "accum-exact-width",
    "select= prunes the O(L^3) eigendecomposition": "pruned-no-eigh",
    # int32 counts (float32 in the reference), float32 normalize/features.
    "float32/int32 dtype contract outside the Haralick tail": "no-f64-promotion",
    "temporal stream state accumulates in signed integers":
        "stream-signed-accum",
}


def _selects_mcc(features) -> bool:
    """Whether the plan's feature selection includes the one feature whose
    computation legitimately contains an eigendecomposition."""
    if features is True:
        return True
    if features is False:
        return False
    return "max_correlation_coefficient" in features


def _vrange(spec) -> tuple[float | None, float | None]:
    return spec.vrange if spec.vrange is not None else (None, None)


def applicable_rules(ctx: LintContext) -> tuple[str, ...]:
    """The rule names whose preconditions ``ctx``'s plan meets.

    The reference's decisions for the same spec and capabilities, plus one
    of the port's own: a CUDA plan of a ``caps.device_kernel`` backend must
    show its kernels' launches (``device-kernel-launches``)."""
    spec = ctx.spec
    caps = ctx.backend.caps
    rules: list[str] = []

    identity = spec.quantize == "uniform" and is_identity_quantize(
        ctx.dtype, spec.levels, *_vrange(spec)
    )

    # -- capability contracts -------------------------------------------
    if caps.fused_quantize and ctx.fused_quantize and not identity:
        # The plan took the fused path (quantize="uniform" on a capable
        # backend): the quantized image must never materialize. Identity
        # workloads are exempt — there the INPUT already holds the levels,
        # and identity-quantize-float-free audits that configuration.
        rules.append("fused-no-int-image")
    if identity and not spec.normalize and ctx.features is False:
        # Identity-quantize workload (uint8, levels=256, vrange (0, 255)):
        # the plan must be free of binning arithmetic. normalize/features
        # legitimately divide, so the probe applies to bare counting plans.
        rules.append("identity-quantize-float-free")
    # The round-trip contract applies to EVERY plan: none for device
    # backends, exactly one for the host-native backend.
    rules.append("no-host-callback")
    if caps.device_kernel and torch.device(ctx.device).type == "cuda":
        # On a CPU tensor a kernel wrapper runs its plain version by design;
        # on the card it must launch its kernel.
        rules.append("device-kernel-launches")

    # -- spec contracts -------------------------------------------------
    if spec.accum == "int" and spec.quantize != "equalized":
        # "equalized" runs a histogram CDF before counting; its bincount is
        # a quantile table, not a count accumulator, and with
        # levels=sqrt(nbins) it is shape-indistinguishable from one.
        rules.append("accum-exact-width")
    if not _selects_mcc(ctx.features):
        rules.append("pruned-no-eigh")
    rules.append("no-f64-promotion")
    if ctx.temporal_window is not None:
        # Incremental temporal plans: the rolling expiry subtraction must
        # never run in an unsigned width (transient underflow would wrap).
        rules.append("stream-signed-accum")

    return tuple(rules)
