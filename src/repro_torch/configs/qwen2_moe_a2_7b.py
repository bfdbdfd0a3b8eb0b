"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

Every layer is an ``"F"`` layer whose MLP is the routed mixture of
experts: 60 experts of width 1408, 4 a token, beside the 4 shared
experts (one fused gated MLP of width 4 x 1408).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # routed expert width (assignment spec)
    vocab_size=151936,
    layer_pattern="F",
    mlp_kind="silu_gated",
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        shared_d_ff=1408,
        gshard_group_size=8192,
        capacity_factor=1.0,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, d_model 256, 4 experts of width
    128 (top 2) and 2 shared, the GShard dispatch, fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            expert_d_ff=128,
            num_shared_experts=2,
            shared_d_ff=128,
        ),
        moe_impl="gshard",
        param_dtype="float32",
        compute_dtype="float32",
    )
