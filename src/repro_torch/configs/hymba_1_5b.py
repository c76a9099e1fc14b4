"""hymba-1.5b — hybrid-head LM: attention and mamba heads IN PARALLEL within
each layer, plus learnable meta tokens and SWA with a few global layers
[arXiv:2411.13676]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    norm="rmsnorm",
    activation="swiglu",
    sliding_window=1024,
    global_first_last=True,    # layers {0, mid, last} use full attention
    meta_tokens=128,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,           # d_inner 3200 → 50 SSM heads
    # 264 (not 256): train seq 4096+128 meta = 4224 = 16×264, so the SSD
    # chunk axis stays divisible by a 16-way model axis. grad_accum bounds
    # the full-batch backward transients.
    ssm_chunk=264,
    grad_accum=4,
    fsdp_params=True,    # 1.5B + AdamW fp32 moments
)
