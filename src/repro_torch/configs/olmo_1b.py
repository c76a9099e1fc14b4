"""olmo-1b — dense LM with NON-PARAMETRIC LayerNorm [arXiv:2402.00838]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_nonparam",  # OLMo: LN without scale/bias
    activation="swiglu",
    tie_embeddings=True,
    fsdp_params=True,    # 1.3B + AdamW fp32 moments: ZeRO-style 2-D shard
)
