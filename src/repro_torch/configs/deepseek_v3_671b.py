"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437].

The main next-token path, as in the JAX package (the paper's
multi-token-prediction head is omitted there too). The first 3 layers
are dense (d_ff 18432); the other 58 are MoE layers of 256 routed
experts of width 2048 (8 a token) and 1 shared expert; every layer's
attention is MLA.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head latent
    head_dim=128,
    d_ff=2048,  # routed expert width (assignment spec)
    vocab_size=129280,
    layer_pattern="F",
    mlp_kind="silu_gated",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        shared_d_ff=2048,
        first_dense_layers=3,
        dense_d_ff=18432,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2412.19437",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers (1 dense of width 256, 1 MoE of 4
    experts, top 2, 1 shared), d_model 256, MLA ranks 128/64, the GShard
    dispatch, fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=128,
        vocab_size=512,
        mla=MLAConfig(
            q_lora_rank=128,
            kv_lora_rank=64,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        ),
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            expert_d_ff=128,
            num_shared_experts=1,
            shared_d_ff=128,
            first_dense_layers=1,
            dense_d_ff=256,
        ),
        moe_impl="gshard",
        param_dtype="float32",
        compute_dtype="float32",
    )
