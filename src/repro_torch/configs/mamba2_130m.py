"""mamba2-130m — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,                # attention-free
    num_kv_heads=0,
    d_ff=0,                     # the mamba mixer replaces the FFN
    vocab_size=50280,
    norm="rmsnorm",
    use_rope=False,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,            # d_inner 1536 → 24 SSD heads
    ssm_chunk=256,
    tie_embeddings=True,
    replicate_params=True,
)
