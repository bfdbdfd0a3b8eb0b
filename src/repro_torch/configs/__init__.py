"""Architecture registry of the port: ``get_config`` / ``get_reduced``.

llama3.2-3b, gemma3-1b, mamba2-2.7b, hymba-1.5b, minitron-4b,
paligemma-3b, whisper-tiny and minicpm3-4b (MLA) are ported; the JAX
package's MoE architectures raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs import (
    gemma3_1b,
    hymba_1_5b,
    llama3_2_3b,
    mamba2_2_7b,
    minicpm3_4b,
    minitron_4b,
    paligemma_3b,
    whisper_tiny,
)
from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig,
    FedRoundSpec,
    MLAConfig,
    ModelConfig,
    SSMConfig,
)

_ARCHS = {"llama3.2-3b": llama3_2_3b, "gemma3-1b": gemma3_1b,
          "mamba2-2.7b": mamba2_2_7b, "hymba-1.5b": hymba_1_5b,
          "minitron-4b": minitron_4b, "paligemma-3b": paligemma_3b,
          "whisper-tiny": whisper_tiny, "minicpm3-4b": minicpm3_4b}

# the JAX package's other architectures, not ported yet (MoE)
_NOT_PORTED = ("deepseek-v3-671b", "qwen2-moe-a2.7b")

def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r}: not ported yet")
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of ``arch_id``."""
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    """The CPU-test variant of ``arch_id`` (2 layers, narrow widths)."""
    return _module(arch_id).reduced()
