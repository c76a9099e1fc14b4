"""repro_torch.sharding — logical-axis constraints the model code calls
(``logical.constrain``); counterpart of the part of ``repro.sharding`` that
``repro.models`` uses. Partition specs come with training (item 18b)."""

from repro_torch.sharding.logical import active, constrain, logical_axis_rules

__all__ = ["active", "constrain", "logical_axis_rules"]
