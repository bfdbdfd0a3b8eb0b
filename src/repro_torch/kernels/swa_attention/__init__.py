"""Sliding-window causal attention (B5): the op of ``"W"`` layers, its
CUDA kernel (``csrc/swa_attention.cu``) and its plain version
(``ref``)."""
from repro_torch.kernels.swa_attention.ops import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    swa_attention,
    swa_attention_cuda,
)
