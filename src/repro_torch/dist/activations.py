"""Activation sharding constraints (the JAX package's
``dist/activations.py``).

A process-wide mesh, set by the launch layer, gates every constraint:
with no mesh set (tests, CPU and single-GPU training, the benchmarks)
the functions are the identity, so model code calls them
unconditionally. With a ``DeviceMesh`` set, a DTensor is redistributed
to the placements of the sanitised spec (the reference's
``with_sharding_constraint``); a plain tensor passes through, as the
port's programs run on one device. Constraints drop axes the mesh lacks
and axes whose size does not divide the dim.
"""
from __future__ import annotations

from typing import Tuple

_MESH = None


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh of the activation
    constraints."""
    global _MESH
    _MESH = mesh


def get_activation_mesh():
    return _MESH


def _sanitize(spec: Tuple, shape: Tuple[int, ...]) -> Tuple:
    """Drop axes the mesh lacks or whose size does not divide the dim."""
    from repro_torch.dist.sharding import axis_sizes

    sizes = axis_sizes(_MESH)
    return tuple(None if ax is None or ax not in sizes
                 or shape[d] % sizes[ax] != 0 else ax
                 for d, ax in enumerate(spec))


def constrain_spec(x, spec: Tuple):
    """Redistribute DTensor ``x`` to the placements of ``spec`` when a
    mesh is installed; the identity otherwise."""
    if _MESH is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import placements

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_MESH, placements(_MESH,
                                            _sanitize(spec, tuple(x.shape))))


def constrain_batch_dim(x):
    """Pin an activation's leading batch dim to the "data" axis."""
    if _MESH is None:
        return x
    return constrain_spec(x, ("data",) + (None,) * (x.dim() - 1))
