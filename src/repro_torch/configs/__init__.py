"""Architecture registry of the port: ``get_config`` / ``get_reduced``.

Every architecture of the JAX package: llama3.2-3b, gemma3-1b,
mamba2-2.7b, hymba-1.5b, minitron-4b, paligemma-3b, whisper-tiny,
minicpm3-4b (MLA), qwen2-moe-a2.7b (MoE) and deepseek-v3-671b (MLA and
MoE). An unknown name raises ``KeyError``.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v3_671b,
    gemma3_1b,
    hymba_1_5b,
    llama3_2_3b,
    mamba2_2_7b,
    minicpm3_4b,
    minitron_4b,
    paligemma_3b,
    qwen2_moe_a2_7b,
    whisper_tiny,
)
from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig,
    FedRoundSpec,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

_ARCHS = {"llama3.2-3b": llama3_2_3b, "gemma3-1b": gemma3_1b,
          "mamba2-2.7b": mamba2_2_7b, "hymba-1.5b": hymba_1_5b,
          "minitron-4b": minitron_4b, "paligemma-3b": paligemma_3b,
          "whisper-tiny": whisper_tiny, "minicpm3-4b": minicpm3_4b,
          "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
          "deepseek-v3-671b": deepseek_v3_671b}


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of ``arch_id``."""
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    """The CPU-test variant of ``arch_id`` (2 layers, narrow widths)."""
    return _module(arch_id).reduced()
