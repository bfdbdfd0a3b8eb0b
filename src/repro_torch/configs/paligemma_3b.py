"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

The SigLIP vision encoder and its projector are a stub, as in the JAX
package: a batch carries ``num_prefix_tokens`` precomputed patch
embeddings of width d_model (``patches``), projected by ``prefix_proj``
and prepended to the text. The language backbone is a prefix LM:
bidirectional over the image prefix, causal over the text.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    layer_pattern="F",
    mlp_kind="gelu_gated",
    num_prefix_tokens=256,
    tie_embeddings=True,
    scale_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2407.07726",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, narrow widths, 16 prefix tokens,
    fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=2,
        num_kv_heads=1,
        head_dim=128,
        d_ff=512,
        vocab_size=512,
        num_prefix_tokens=16,
        param_dtype="float32",
        compute_dtype="float32",
    )
