"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Hymba runs attention heads and SSM heads in parallel within every layer
(layer kind ``"Y"``). The published model uses global attention in only
3 layers and sliding-window attention elsewhere; the JAX package adapts
it to a uniform sliding-window path for the attention heads (window
1024), and so does this copy.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    layer_pattern="Y",
    sliding_window=1024,
    mlp_kind="silu_gated",
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2411.13676",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, d_model 256, 4q/2kv heads x 64,
    window 64, chunk 32, fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                      chunk_size=32),
        param_dtype="float32",
        compute_dtype="float32",
    )
