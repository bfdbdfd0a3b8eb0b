"""Carry the JAX package's state across to the port.

JAX's ``init_params`` draws from threefry keys, which torch cannot
replay, so a comparison of the two packages starts both from the same
numpy weights through these functions. Inputs are the JAX pytrees with
their leaves as numpy arrays (``jax.tree.map(np.asarray, tree)`` on the
JAX side); this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.api import ServerState
from repro_torch.device import resolve_device


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists / tuples of arrays -> ``{"a/0/b": leaf}``, the
    port's flat leaf paths (dict keys in sorted order, as JAX flattens)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dev)


def params_from_jax(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX parameter pytree (numpy leaves) -> the port's flat dict of
    tensors on ``device``, by path, dtype kept."""
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev) for k, v in flatten_tree(tree).items()}


def state_from_jax(state, device="cuda"):
    """A JAX ``ServerState`` (numpy leaves) -> the port's ``ServerState``,
    its server-optimizer slots included (momentum's ``m``; adam's ``m``,
    ``v`` and ``t``); any other tree (e.g. client-store rows of control
    variates or solver slots, leaves ``(N, ...)``) -> a flat dict, slot
    rows keyed ``"m/<leaf>"`` as the port's solver store keys them."""
    if hasattr(state, "x") and hasattr(state, "c"):
        dev = resolve_device(device)
        opt_state = {k: (params_from_jax(v, dev) if isinstance(v, dict)
                         else _to_tensor(v, dev))
                     for k, v in state.opt_state.items()}
        return ServerState(x=params_from_jax(state.x, dev),
                           c=params_from_jax(state.c, dev),
                           opt_state=opt_state)
    return params_from_jax(state, device)
