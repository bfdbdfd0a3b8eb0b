"""Arithmetic over parameter trees (the JAX package's ``core/tree.py``).

A tree here is a flat ``dict[str, Tensor]`` keyed by the JAX pytree's
leaf path (``"layers/0/attn/wq"``); see ``repro_torch.convert``. Every
helper returns a new dict and keeps the leaf order of its first argument.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def _path_key(path: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in path.split("/"))


def leaf_keys(tree: Tree):
    """The tree's keys in the JAX pytree's flatten order: dict keys
    sorted, list indices in numeric order ("leaf j" of a per-leaf key
    fold is the same leaf in both packages)."""
    return sorted(tree, key=_path_key)


def tree_map(fn, *trees: Tree) -> Tree:
    """``{k: fn(a[k], b[k], ...)}`` over the keys of the first tree."""
    first = trees[0]
    for t in trees[1:]:
        if t.keys() != first.keys():
            raise ValueError(f"tree structures differ: {sorted(first)} vs "
                             f"{sorted(t)}")
    return {k: fn(*(t[k] for t in trees)) for k in first}


def tree_add(a: Tree, b: Tree) -> Tree:
    """Leafwise a + b."""
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    """Leafwise a - b."""
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s: float) -> Tree:
    """Leafwise a * s for a scalar s, in each leaf's dtype."""
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a: Tree) -> Tree:
    """A zeros tree shaped/typed/placed like ``a``."""
    return tree_map(torch.zeros_like, a)


def tree_norm(a: Tree) -> torch.Tensor:
    """fp32 L2 norm over all leaves (a 0-d tensor).

    Sums squares leaf by leaf (``linalg.vector_norm`` in fp32), so no
    fp32 copy of a whole bf16 leaf is kept at once."""
    sq = [torch.linalg.vector_norm(v, dtype=torch.float32) ** 2
          for v in a.values()]
    return torch.sqrt(torch.stack(sq).sum())


def tree_gather(store: Tree, ids) -> Tree:
    """Rows ``ids`` of a stacked store: (N, ...) leaves -> (S, ...)."""
    idx = torch.as_tensor(ids, dtype=torch.long)
    return tree_map(lambda leaf: leaf[idx.to(leaf.device)], store)


def tree_scatter(store: Tree, ids, new: Tree) -> Tree:
    """Write (S, ...) leaves back into rows ``ids`` of a (N, ...) store.

    Updates ``store`` in place (the JAX version returns a new store;
    under a donated jit it too writes in place) and returns it."""
    idx = torch.as_tensor(ids, dtype=torch.long)
    for k, leaf in store.items():
        leaf[idx.to(leaf.device)] = new[k].to(leaf.device, leaf.dtype)
    return store


def tree_flatten_slots(slots) -> Tree:
    """A local solver's nested slots -> one flat tree: ``{"m": {"x": a},
    "t": t}`` -> ``{"m/x": a, "t": t}`` (the JAX slot pytree's leaf
    paths), the layout of the client store's rows."""
    flat: Tree = {}
    for name, sub in slots.items():
        if isinstance(sub, dict):
            flat.update({f"{name}/{k}": v for k, v in sub.items()})
        else:
            flat[name] = sub
    return flat


def tree_nest_slots(flat: Tree):
    """The inverse of :func:`tree_flatten_slots`: split each key at its
    first ``/``."""
    slots = {}
    for key, v in flat.items():
        name, sep, leaf = key.partition("/")
        if sep:
            slots.setdefault(name, {})[leaf] = v
        else:
            slots[name] = v
    return slots
