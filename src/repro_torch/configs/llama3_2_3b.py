"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B family, 3B size]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    layer_pattern="F",
    mlp_kind="silu_gated",
    rope_theta=500000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="hf:meta-llama/Llama-3.2-1B (3B config)",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, narrow widths, fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
