"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,  # mamba blocks subsume the MLP
    vocab_size=50280,
    layer_pattern="M",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    norm_kind="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    citation="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    """The CPU-test variant: 2 layers, d_model 256, d_state 32, chunk 32,
    fp32."""
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm=SSMConfig(d_state=32, head_dim=64, expand=2, conv_kernel=4,
                      chunk_size=32),
        param_dtype="float32",
        compute_dtype="float32",
    )
