"""internlm2-1.8b — dense GQA LM [arXiv:2403.17297]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
    fsdp_params=True,    # 1.9B + AdamW fp32 moments
)
