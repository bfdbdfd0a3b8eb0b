"""Mesh construction (the JAX package's ``launch/mesh.py``).

Functions, not module constants, so importing this module touches no
process group. A mesh's dims are named ``("data", "model")``, with a
leading ``"pod"`` on the multi-pod mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _ensure_group(backend: str) -> None:
    """A one-process group over a ``HashStore`` (no network) when no
    process group exists."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 ("data", "model") mesh, or 2x16x16 with a leading "pod";
    raises where the world has fewer ranks than the mesh has devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = 1
    for n in shape:
        ndev *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} ranks but the world has {world}: "
            f"run `python -m repro_torch.launch.dryrun --mesh "
            f"{'x'.join(map(str, shape))}`, which counts the per-device "
            f"state of this mesh on shapes alone")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A small ("data", "model") mesh over the process group's ranks
    (tests: 1x1, over a one-process group it starts when there is none:
    gloo for the CPU, nccl for the card)."""
    dev = resolve_device(device)
    _ensure_group("gloo" if dev.type == "cpu" else "nccl")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
