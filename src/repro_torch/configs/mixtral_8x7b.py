"""mixtral-8x7b — sparse MoE: 8 experts, top-2 routing, SWA
[arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    # Dispatch strategy is sequence-regime dependent: the one-hot einsum's
    # dispatch tensor is O(2.5·T²), fine at train_4k, too large at
    # prefill_32k. Config default = einsum (8 experts); serving launchers
    # override to gather for long prefill.
    moe_dispatch="einsum",
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    fsdp_params=True,
    grad_accum=4,          # 47B total params: 2-D shard + TP'd experts
)
