"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

The mel spectrogram and the conv feature extractor are a stub, as in the
JAX package: a batch carries precomputed frame embeddings (``frames``,
(batch, 1500, 384)). The backbone is a 4-layer bidirectional encoder and
a 4-layer causal decoder with cross-attention, layer norms and the plain
gelu MLP.
"""
import dataclasses

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    layer_pattern="F",
    mlp_kind="gelu",
    norm_kind="layernorm",
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    citation="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 + 2 layers, d_model 128, 64 frames."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab_size=512,
        encoder=EncoderConfig(num_layers=2, num_frames=64),
    )
