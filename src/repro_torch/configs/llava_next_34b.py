"""llava-next-34b — VLM; the TRANSFORMER BACKBONE only (Yi-34B-class).

The anyres-tiling vision frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings (B, S, d_model) for
train/prefill; decode consumes text tokens. [hf:llava-hf/llava-v1.6]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=5_000_000.0,
    embeds_input=True,          # stub frontend: precomputed patch embeddings
    param_dtype="bfloat16",     # 34B: bf16 storage + Adafactor
    optimizer="adafactor",
    fsdp_params=True,
    kv_quant=True,             # int8 KV: halves the decode KV term
    grad_accum=4,
)
