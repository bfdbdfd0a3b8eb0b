"""Differential privacy for the federated round (the JAX package's
``core/privatizer.py``): the ``Privatizer`` registry.

A privatizer owns three things:

  * **per-update L2 clipping** of each sampled client's model delta dy
    to ``C = spec.clip_norm``, measured by :func:`global_norm`, one fp32
    reduction over the concatenated ravel of every leaf. The clip meets
    ``float(global_norm(clipped)) <= C`` in truth: it compares against
    the largest fp32 not above ``C``, re-measures the tree as it will be
    returned (cast back to each leaf's dtype, on the same device, by the
    same function), and shrinks by ``min(C/norm, 1 - 2^-23)`` until that
    measure holds. The engine, the metric and a caller's check all use
    this one measure, so none of them can read the clipped tree above C.
  * **Gaussian noise** calibrated to C and ``spec.noise_multiplier`` z:
    ``server_gauss`` adds ``N(0, (C·z/S)²)`` to the aggregated mean;
    ``distributed_gauss`` adds ``N(0, (C·z/sqrt(S))²)`` to each client's
    clipped delta before the uplink codec.
  * the accountant ``eps(T) = A + 2·sqrt(A·B)``, ``A = 2·T·q²/z²``,
    ``B = ln(1/delta)``, ``q = S/N`` (float64 on the host; an fp32 twin
    for the round's metric).

Order in the round: clip, then client noise, then the uplink codec;
server noise lands on the mean before the server optimizer. Noise draws
come from ``core.streams``: client ``i`` of round ``t`` uses the key
``(seed+3, t, 0, i)``, the server ``(seed+3, t, 1)``, leaf ``j`` one more
fold.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import streams
from repro_torch.core.tree import leaf_keys

# the largest fp32 below 1: multiplying a positive normal fp32 by it
# strictly decreases the value, so the clip's loop ends
_SHRINK = np.float32(1.0 - 2.0 ** -23)


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm of a tree as one reduction over the concatenated
    ravel of every leaf (flatten order), a 0-d tensor."""
    leaves = [tree[k].reshape(-1).float() for k in leaf_keys(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    flat = torch.cat(leaves) if len(leaves) > 1 else leaves[0]
    return torch.sqrt(torch.sum(flat * flat))


def _fp32_at_most(x: float) -> np.float32:
    """The largest fp32 that is not above ``x``."""
    c = np.float32(x)
    if float(c) > x:
        c = np.nextafter(c, np.float32(-np.inf))
    return c


def clip_by_global_norm(tree, clip_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """L2-clip ``tree`` so that ``float(global_norm(clipped)) <=
    clip_norm``. Returns ``(clipped, was_clipped)``, the flag a 0-d fp32
    0/1. A tree within the bound comes back bitwise as it was (the same
    tensors). A NaN norm compares false and passes through."""
    c = _fp32_at_most(float(clip_norm))
    n0 = global_norm(tree)
    if not bool(n0 > float(c)):
        return tree, torch.zeros((), dtype=torch.float32, device=n0.device)
    t32 = {k: v.float() for k, v in tree.items()}
    n = n0
    while True:
        s = min(np.float32(c / np.float32(n.item())), _SHRINK)
        # s == 0 only when the norm is inf: zero the tree, not inf * 0
        t32 = {k: (v * float(s) if s > 0 else torch.zeros_like(v))
               for k, v in t32.items()}
        out = {k: t32[k].to(tree[k].dtype) for k in tree}
        n = global_norm(out)
        if not bool(n > float(c)):
            return out, torch.ones((), dtype=torch.float32, device=n0.device)


def gaussian_noise_like(tree, key: streams.StreamKey, std: float):
    """``tree + N(0, std²)`` in fp32, cast back to each leaf's dtype; leaf
    ``j`` (flatten order) draws from ``key.fold_in(j)``."""
    std32 = float(np.float32(std))
    out = {}
    for j, k in enumerate(leaf_keys(tree)):
        leaf = tree[k]
        noise = streams.normal(key.fold_in(j), leaf.shape)
        out[k] = (leaf.float() + std32 * noise).to(leaf.dtype)
    return {k: out[k] for k in tree}


class Privatizer:
    """One differential-privacy mechanism for the federated round.

      name      registry key
      clips     whether client deltas are L2-clipped to spec.clip_norm
      needs_key whether the engine must pass the privacy stream
      noise_at  "none" | "client" | "server", where noise lands
    """

    name: str = ""
    clips: bool = False
    needs_key: bool = False
    noise_at: str = "none"

    def clip(self, spec, dy):
        return clip_by_global_norm(dy, spec.clip_norm)

    def client_noise(self, spec, dy, key):
        raise NotImplementedError

    def server_noise(self, spec, dy_mean, key):
        raise NotImplementedError

    def _moment(self, spec, rounds):
        """A(T) = 2·T·q²/z²."""
        q = spec.num_sampled / spec.num_clients
        return 2.0 * rounds * q * q / (spec.noise_multiplier ** 2)

    def epsilon(self, spec, rounds: int) -> float:
        """Privacy spend (float64) after ``rounds`` rounds at
        ``delta = spec.dp_delta``."""
        a = self._moment(spec, float(rounds))
        b = math.log(1.0 / spec.dp_delta)
        return a + 2.0 * math.sqrt(a * b)


class NoPrivatizer(Privatizer):
    """DP off: the engine skips every hook."""

    name = "none"

    def epsilon(self, spec, rounds: int) -> float:
        return float("inf")


class ServerGaussian(Privatizer):
    """Trusted aggregator: clip every client delta to C, add
    ``N(0, (C·z/S)²)`` to the aggregated mean."""

    name = "server_gauss"
    clips = True
    needs_key = True
    noise_at = "server"

    def server_noise(self, spec, dy_mean, key):
        std = spec.clip_norm * spec.noise_multiplier / spec.num_sampled
        return gaussian_noise_like(dy_mean, key, std)


class DistributedGaussian(Privatizer):
    """Clip to C, then each client adds ``N(0, (C·z/sqrt(S))²)`` before
    its uplink; the S-client mean carries the server mechanism's std."""

    name = "distributed_gauss"
    clips = True
    needs_key = True
    noise_at = "client"

    def client_noise(self, spec, dy, key):
        std = (spec.clip_norm * spec.noise_multiplier
               / math.sqrt(spec.num_sampled))
        return gaussian_noise_like(dy, key, std)


_PRIVATIZERS: Dict[str, Privatizer] = {}


def register_privatizer(priv: Privatizer) -> Privatizer:
    """Register a ``Privatizer`` instance under its ``name``."""
    assert priv.name, "Privatizer subclasses must set a name"
    _PRIVATIZERS[priv.name] = priv
    return priv


def get_privatizer(name: str) -> Privatizer:
    """Look up a registered privatizer; unknown names fail loudly."""
    try:
        return _PRIVATIZERS[name]
    except KeyError:
        raise KeyError(
            f"unknown privatizer {name!r}; registered: {privatizer_names()}"
        ) from None


def privatizer_names() -> Tuple[str, ...]:
    """Sorted names of all registered privatizers."""
    return tuple(sorted(_PRIVATIZERS))


for _p in (NoPrivatizer(), ServerGaussian(), DistributedGaussian()):
    register_privatizer(_p)


def resolve_privatizer(spec) -> str:
    """The spec's privatizer name."""
    return spec.privatizer
