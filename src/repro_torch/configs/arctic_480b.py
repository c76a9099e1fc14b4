"""arctic-480b — dense-MoE hybrid: 128 experts top-2 IN PARALLEL with a dense
residual FFN [hf:Snowflake/snowflake-arctic-base].

The paper-technique connection: the 128-way router histogram/dispatch is the
paper's large-L conflict regime (GLCM L=128); router statistics and dispatch
use the conflict-free one-hot counting primitive (kernels.ops.onehot_count).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_residual=True,
    dense_residual_ff=4864,
    # 128 experts: GShard dense-dispatch one-hot is O(T × E·C) = O(2.5·T²)
    # bytes per layer → index-gather dispatch instead. Router stats still
    # use the paper's conflict-free counting primitive.
    moe_dispatch="gather",
    param_dtype="bfloat16",    # 480B: bf16 storage + Adafactor
    optimizer="adafactor",
    fsdp_params=True,
    kv_quant=True,             # int8 KV: halves the decode_32k KV term
    grad_accum=8,
    shard_experts=True,        # experts over 'model', expert d_model over 'data'
)
