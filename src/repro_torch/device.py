"""The device rule of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back to it.

Inside ``launch.census`` (``kernels.counts.census``, which holds the
device type the census counts on) the program runs on fake tensors,
which allocate nothing and launch nothing, and CUDA resolves without a
card, so a census counts the card path on any machine. Where
PyTorch has no CUDA runtime (a CPU-only build), autograd cannot run on
fake CUDA tensors, so there the census's fake tensors lie on the meta
device and stand for the card's: "cuda" resolves to "meta", and the
kernel wrappers take the card's route for them (``kernels.counts.fake``).
Outside a census, asking for CUDA where there is none raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import counts


@functools.lru_cache(maxsize=64)
def _parse(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no CUDA
    device is present (no silent fallback to the CPU), except inside a
    census of the card path (there it may resolve to the meta device
    that stands for the card). The parse is cached: the fused steps
    resolve their device at every local step."""
    dev = _parse(device)
    stand = counts.census_stand()
    if dev.type == "meta":
        if stand != "meta":
            raise ValueError(f"unsupported device {str(dev)!r}")
    elif dev.type == "cuda":
        if stand == "meta":
            return torch.device("meta")
        if stand != "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                f" is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def check_on(what: str, t: torch.Tensor, dev: torch.device) -> None:
    """Raise unless tensor ``t`` lies on ``dev``'s device type."""
    if t.device.type != dev.type:
        raise ValueError(f"{what}: tensor on {t.device}, expected {dev}")
