"""Model configuration — one frozen dataclass covers all ten assigned
architectures (dense / MoE / SSM / hybrid / enc-dec / VLM backbones).

The port's copy of ``repro.configs.base`` (pure Python, field for field the
same, so ``dataclasses.asdict`` of every config equals the reference's).

Every field is static metadata; params and caches are derived from it. The
exact per-arch values live in ``configs/<arch>.py`` and are taken verbatim
from the assignment table (public literature).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family

    # Transformer backbone.
    num_layers: int
    d_model: int
    num_heads: int          # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 → d_model // num_heads

    # Norm / activation / embeddings.
    norm: Literal["rmsnorm", "layernorm", "layernorm_nonparam"] = "rmsnorm"
    activation: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True

    # Attention variants.
    # "context": Q-sequence sharded over 'model' (head-count agnostic).
    # "heads_tp": heads sharded over 'model' (needs heads % 16 == 0; zero
    #             K/V all-gather).
    attn_layout: str = "context"
    sliding_window: int | None = None       # SWA window (tokens), None = full
    global_layer_every: int = 0             # >0: every k-th layer is full attn
    global_first_last: bool = False         # hymba: first+middle+last global

    # MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False        # arctic: dense FFN in parallel
    dense_residual_ff: int = 0              # width of that dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: Literal["einsum", "gather"] = "einsum"

    # SSM (mamba2 / hymba branch).
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # Hybrid (hymba).
    meta_tokens: int = 0

    # Encoder-decoder (whisper).
    is_encoder_decoder: bool = False
    encoder_layers: int = 0                 # decoder layers = num_layers

    # VLM / audio stub frontend: train/prefill consume precomputed embeddings.
    embeds_input: bool = False

    # Numerics / training policy.
    param_dtype: str = "float32"            # master/storage dtype
    compute_dtype: str = "bfloat16"
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    remat: bool = True

    # Sharding hints (see sharding/partition.py).
    fsdp_params: bool = False               # 2-D param sharding (big models)
    shard_experts: bool = False             # expert-parallel over 'model'
    replicate_params: bool = False          # small models: pure DP

    # Dry-run accounting: fully unroll layer scans so cost_analysis() and the
    # HLO collective parse see every layer (XLA counts while-loop bodies
    # once). Production keeps scans rolled (compile time).
    scan_unroll: bool = False

    # int8 KV cache (per-token-per-head symmetric scales): halves decode's
    # dominant HBM term. Off by default.
    kv_quant: bool = False

    # Gradient accumulation at the production shapes (train cells): bounds
    # the per-microbatch backward transients.
    grad_accum: int = 1

    # --- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (shardable over 16-way model
        axis; logits for padded ids are masked to -inf)."""
        return _round_up(self.vocab_size, 128)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (decode state is O(window)/O(1), not O(T))."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def window_for_layer(self, i: int) -> int | None:
        """Sliding window for layer i (None = full attention)."""
        if self.sliding_window is None:
            return None
        if self.global_first_last and i in (0, self.num_layers // 2, self.num_layers - 1):
            return None
        if self.global_layer_every and (i % self.global_layer_every == 0):
            return None
        return self.sliding_window

    def validate(self) -> None:
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not a multiple "
                             f"of kv heads {self.num_kv_heads}")
        if self.family == "moe" and not (self.num_experts and self.num_experts_per_tok):
            raise ValueError(f"{self.name}: moe family needs experts/top-k")
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError(f"{self.name}: ssm family needs ssm_state")
        if self.is_encoder_decoder and not self.encoder_layers:
            raise ValueError(f"{self.name}: enc-dec needs encoder_layers")

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            meta_tokens=min(self.meta_tokens, 4),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            dense_residual_ff=64 if self.moe_dense_residual else 0,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            sliding_window=8 if self.sliding_window else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            kv_quant=False,   # exact-consistency tests; test_kv_quant covers int8
            grad_accum=1,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
