"""minicpm3-4b [dense] — MLA attention [hf:openbmb/MiniCPM3-4B].

Every layer is an ``"F"`` layer whose attention is multi-head latent
attention: q through a rank-768 latent, keys and values through one
rank-256 latent shared by the 40 heads, each head's q/k a 64-wide
non-RoPE part and a 32-wide RoPE part (one RoPE key shared by the
heads), its v 64 wide.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,  # MLA: per-head latent, no GQA grouping
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    layer_pattern="F",
    mlp_kind="silu_gated",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="hf:openbmb/MiniCPM3-4B",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, d_model 256, 4 heads, latent
    ranks 128/64, nope 32 + rope 16, v 32, fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        mla=MLAConfig(
            q_lora_rank=128,
            kv_lora_rank=64,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        ),
        param_dtype="float32",
        compute_dtype="float32",
    )
