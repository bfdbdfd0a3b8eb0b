"""Per-leaf parameter partition rules (the JAX package's
``dist/sharding.py``).

``param_partition_spec`` is pure shape logic: it works against a
shape-only mesh (any object whose ``shape`` maps axis names to sizes)
as well as a ``torch.distributed.device_mesh.DeviceMesh``, and never
assigns a mesh axis to a dim the axis size does not divide, so a spec is
valid on any mesh. A spec is a tuple with one entry a tensor dim: an
axis name, or None (the dim is not split), entry for entry the
reference's ``PartitionSpec``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

Spec = Tuple[Optional[str], ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or of a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _pick_dim(shape: Tuple[int, ...], start: int, axis_size: int,
              taken) -> Optional[int]:
    """Largest dim (ties to the later dim, the usual tensor-parallel
    convention of splitting the output axis) divisible by ``axis_size``."""
    best = None
    for d in range(start, len(shape)):
        if d in taken or shape[d] % axis_size != 0:
            continue
        if best is None or shape[d] >= shape[best]:
            best = d
    return best


def param_partition_spec(path: str, shape: Tuple[int, ...], mesh,
                         strategy: str, *, lead_stack_dims: int = 0) -> Spec:
    """The spec of one parameter leaf.

    path:            the leaf's flat key (``"layers/0/attn/wq"``)
    lead_stack_dims: leading dims that are stacking axes (layer stacks,
                     sampled clients), never split here.
    strategy:        client_parallel (params replicated over "data") or
                     client_sequential (FSDP: params also split over
                     "data").
    """
    del path  # the rules are shape-driven; the path picks the stack dims
    shape = tuple(shape)
    entries = [None] * len(shape)
    taken = set(range(lead_stack_dims))
    model = _axis_size(mesh, "model")
    if model > 1:
        d = _pick_dim(shape, lead_stack_dims, model, taken)
        if d is not None:
            entries[d] = "model"
            taken.add(d)
    if strategy == "client_sequential":
        data = _axis_size(mesh, "data")
        if data > 1:
            d = _pick_dim(shape, lead_stack_dims, data, taken)
            if d is not None:
                entries[d] = "data"
                taken.add(d)
    return tuple(entries)
