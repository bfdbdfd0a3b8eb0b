"""Architecture registry of the port: ``get_config`` / ``get_reduced``.

Every architecture of the JAX package: llama3.2-3b, gemma3-1b,
mamba2-2.7b, hymba-1.5b, minitron-4b, paligemma-3b, whisper-tiny,
minicpm3-4b (MLA), qwen2-moe-a2.7b (MoE) and deepseek-v3-671b (MLA and
MoE), in ``ARCH_IDS`` in the reference's order. An unknown name raises
``KeyError``. The input shapes and round plans are ``configs.shapes``'.
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
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    TrainConfig,
)
from repro_torch.configs.shapes import (  # noqa: F401
    LONG_CONTEXT_ARCHS,
    SHAPES,
    default_round_spec,
    supports_shape,
)

_ARCHS = {"llama3.2-3b": llama3_2_3b, "hymba-1.5b": hymba_1_5b,
          "minicpm3-4b": minicpm3_4b, "whisper-tiny": whisper_tiny,
          "gemma3-1b": gemma3_1b, "paligemma-3b": paligemma_3b,
          "deepseek-v3-671b": deepseek_v3_671b,
          "mamba2-2.7b": mamba2_2_7b, "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
          "minitron-4b": minitron_4b}

ARCH_IDS = tuple(_ARCHS)


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
