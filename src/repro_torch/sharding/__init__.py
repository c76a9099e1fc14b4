"""repro_torch.sharding — the port's counterpart of ``repro.sharding``:
partition specs per parameter path, batch, cache and optimizer state
(``partition``) and the logical-axis constraints the model code calls
(``logical``), both on a ``torch.distributed`` ``DeviceMesh``."""

from repro_torch.sharding.logical import active, constrain, default_rules, logical_axis_rules
from repro_torch.sharding.partition import (
    batch_axes,
    batch_size_divisor,
    batch_specs,
    cache_specs,
    decode_token_specs,
    logits_spec,
    named,
    optimizer_state_specs,
    param_specs,
    spec_for_path,
)

__all__ = [
    "active",
    "batch_axes",
    "batch_size_divisor",
    "batch_specs",
    "cache_specs",
    "constrain",
    "decode_token_specs",
    "default_rules",
    "logical_axis_rules",
    "logits_spec",
    "named",
    "optimizer_state_specs",
    "param_specs",
    "spec_for_path",
]
