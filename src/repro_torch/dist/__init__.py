"""The port's distribution layer (the JAX package's ``repro.dist``):
partition specs of the model state, client state and batches, and the
sharded population-store backend (``dist.store``).

Axis convention (``launch.mesh``): ``("data", "model")``, optionally
with a leading ``"pod"`` axis. Two parameter strategies follow the round
strategies:

  client_parallel    params replicated over "data", tensor dims over
                     "model"; the client axis of c_i and of the batches
                     over "data".
  client_sequential  FSDP: params split over "data" and "model"
                     (deepseek-v3).

Every rule is divisibility-guarded, so any leaf on any mesh gets a valid
spec; on a 1x1 mesh every spec is all None. Each ``partition_*`` maps a
tree of leaves with a ``shape`` (tensors, meta tensors, nested dicts of
them) to a like tree of :class:`NamedSharding`: the spec, and on a real
``DeviceMesh`` the DTensor placements of that spec (``Shard(d)`` for the
tensor dim an axis splits, ``Replicate()`` for an axis that splits none).
The port runs its programs on one device; these trees are what the dry
run reads (``launch.dryrun``'s per-device bytes) and what a multi-GPU
run would distribute its tensors by.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.dist import activations  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    Spec,
    axis_sizes,
    param_partition_spec,
)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        """One DTensor placement per mesh dim, in the mesh's order; only
        on a ``DeviceMesh``."""
        return placements(self.mesh, self.spec)

    def shard_bytes(self, shape, itemsize: int) -> int:
        """The bytes of one device's shard of a leaf of ``shape``."""
        sizes = axis_sizes(self.mesh)
        n = itemsize
        for dim, ax in zip(shape, self.spec):
            n *= dim // sizes[ax] if ax is not None else dim
        return n


def placements(mesh, spec: Spec) -> Tuple:
    """The DTensor placements of ``spec`` on DeviceMesh ``mesh``: for each
    mesh dim ``Shard(d)`` where spec entry d names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"placements need a DeviceMesh, got {mesh!r}")
    out = []
    for name in names:
        dims = [d for d, ax in enumerate(spec) if ax == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _map(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict of leaves, the path its keys
    joined by "/"."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _spec_tree(shapes, mesh, strategy, *, lead_dims: int = 0,
               lead_axis=None):
    """Every leaf's spec; ``lead_dims`` leading dims are reserved (stacked
    clients), dim 0 split over ``lead_axis`` when divisible."""
    lead_size = axis_sizes(mesh).get(lead_axis, 1)

    def mk(path, leaf):
        # "layers/..." the model's stacked groups; "layers.<i>..." the
        # flat delta-tree keys of an update space (core/update_space.py)
        stacked = path.startswith("layers/") or path.startswith("layers.")
        shape = tuple(leaf.shape)
        spec = list(param_partition_spec(
            path, shape, mesh, strategy,
            lead_stack_dims=lead_dims + (1 if stacked else 0)))
        if lead_axis is not None and shape and shape[0] % lead_size == 0:
            spec[0] = lead_axis
        return NamedSharding(mesh, tuple(spec))

    return _map(mk, shapes)


def partition_params(shapes, mesh, strategy, *, expert_parallel: bool = False):
    """The server and client model state (x, c, y). The rules are
    shape-driven, so a delta tree of an update space (LoRA factors,
    head_only subtrees) splits by the same logic as the parameters."""
    del expert_parallel  # experts ride the "model" axis in this layer
    return _spec_tree(shapes, mesh, strategy)


def partition_client_states(shapes, mesh, strategy, *,
                            expert_parallel: bool = False):
    """c_i with leaves (S, ...): the sampled-client axis over "data"
    under client_parallel."""
    del expert_parallel
    lead_axis = "data" if strategy == "client_parallel" else None
    return _spec_tree(shapes, mesh, strategy, lead_dims=1,
                      lead_axis=lead_axis)


def partition_client_store(shapes, mesh, strategy):
    """The scanned engine's client store, leaves (N, ...): the all-clients
    axis over "data" where the axis size divides N, so the gathered rows
    of a round land on the data groups that run it. Leafwise, so a store
    of row families (``{"c_i": ..., "residual": ...}``) splits as the bare
    one."""
    return _spec_tree(shapes, mesh, strategy, lead_dims=1, lead_axis="data")


def partition_train_batch(shapes, mesh, strategy):
    """Round batches, leaves (S, K, b, ...): the client axis over "data"
    under client_parallel; under client_sequential the local batch dim b
    instead."""
    data = axis_sizes(mesh).get("data", 1)

    def mk(_, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if strategy == "client_parallel":
            if len(shape) >= 1 and shape[0] % data == 0:
                entries[0] = "data"
        elif len(shape) >= 3 and shape[2] % data == 0:
            entries[2] = "data"
        return NamedSharding(mesh, tuple(entries))

    return _map(mk, shapes)


def partition_serve_batch(shapes, mesh, *, cache_mode: str = "data"):
    """Serving inputs and caches: the batch dim over "data";
    ``cache_mode="model"`` also splits dim 2 (the heads of a (B, S, H, D)
    cache) over "model" when divisible."""
    sizes = axis_sizes(mesh)

    def mk(_, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % sizes.get("data", 1) == 0:
            entries[0] = "data"
        if (cache_mode == "model" and len(shape) >= 4
                and shape[2] % sizes.get("model", 1) == 0):
            entries[2] = "model"
        return NamedSharding(mesh, tuple(entries))

    return _map(mk, shapes)


def replicated(mesh):
    """Full replication (scalars, metrics, small host state)."""
    return NamedSharding(mesh, ())
