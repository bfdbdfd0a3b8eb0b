"""gemma3-1b [dense] — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern="WWWWWF",  # 5 local (sliding-window) : 1 global
    sliding_window=512,
    mlp_kind="gelu_gated",
    rope_theta=1000000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="hf:google/gemma-3-1b-pt",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers ("WF"), narrow widths, window 64,
    fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        layer_pattern="WF",
        d_model=256,
        num_heads=2,
        num_kv_heads=1,
        head_dim=128,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        param_dtype="float32",
        compute_dtype="float32",
    )
