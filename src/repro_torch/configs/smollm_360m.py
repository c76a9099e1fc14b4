"""smollm-360m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-360M]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
    replicate_params=True,   # 360M: pure-DP-friendly; TP only on d_ff/vocab
)
