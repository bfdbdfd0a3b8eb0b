"""The device rule of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back to it."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no CUDA
    device is present (no silent fallback to the CPU). Cached: the fused
    steps resolve their device at every local step."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def check_on(what: str, t: torch.Tensor, dev: torch.device) -> None:
    """Raise unless tensor ``t`` lies on ``dev``'s device type."""
    if t.device.type != dev.type:
        raise ValueError(f"{what}: tensor on {t.device}, expected {dev}")
