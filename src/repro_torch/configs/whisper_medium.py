"""whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

The conv/mel frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed frame embeddings (B, T_enc, d_model) to the encoder.
Positions are sinusoidal (``use_rope=False``); attention is full (MHA).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,              # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    use_rope=False,             # absolute sinusoidal positions
    embeds_input=True,          # stub frontend: precomputed frame embeddings
    fsdp_params=True,           # 0.8B enc-dec + AdamW fp32 moments
    # Context parallelism by default; heads_tp (16 heads == 16 shards) stays
    # a supported layout.
    attn_layout="context",
)
