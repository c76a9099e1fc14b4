"""The plan-contract analyzer: op-record lint rules, capability contracts and
the registry audit CLI (``python -m repro_torch.analysis.audit``).

Counterpart of ``repro.analysis``. Every invariant the paper's "optimize
without losing accuracy" claim rests on (no materialized quantized image in
fused plans, no float binning in identity-quantize plans, exact integer
accumulation, no host round trips in device plans, no un-pruned O(L³)
eigendecompositions, no float64 outside the Haralick tail, signed rolling
counts, and a kernel, never its plain version, on the card) is checked
against the record of one real call of the plan: its aten ops, the scopes
they ran in (:mod:`repro_torch.analysis.scopes`) and its kernel launches.
The reference traces abstractly instead; a PyTorch plan launches its kernels
through ``ctypes``, which no tracer follows.

The names below load at first use: the core and kernel modules import
``repro_torch.analysis.scopes``, and an eager import here would be circular.
"""

__all__ = [
    "Finding",
    "LintContext",
    "OpRecord",
    "PlanContractError",
    "PlanRecord",
    "Rule",
    "get_rule",
    "has_op",
    "int_image_ops",
    "lint_plan",
    "op_names",
    "record_call",
    "record_plan",
    "register_rule",
    "registered_rules",
]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.analysis import op_lint

        return getattr(op_lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
