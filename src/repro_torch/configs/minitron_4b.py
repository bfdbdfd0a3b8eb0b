"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679].

Its embedding table and its output projection (``unembed``) are
separate leaves (``tie_embeddings=False``).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern="F",
    mlp_kind="silu_gated",  # nemotron uses squared-relu; the JAX package keeps silu
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2407.14679",
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
