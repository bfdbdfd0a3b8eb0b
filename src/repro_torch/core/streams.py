"""Keyed, stateless random draws: the port's compression, privacy and
LoRA-init streams.

The JAX package folds threefry keys: compression draws from
``key(seed + 2)``, privacy from ``key(seed + 3)``, each folded by the
round ``t``, then by ``0`` (a client) or ``1`` (the downlink broadcast,
the server), then by the client ``i``, then by the leaf ``j``; the LoRA
init draws target ``i``'s factor A from ``key(seed + 4)`` folded by
``i``. Torch cannot replay threefry, so the port keeps the same fold
paths and derives each draw's ``torch.Generator`` seed from
``np.random.SeedSequence(path)``, on the key's device:

  a client's draw   (base, t, 0, i, j)
  a broadcast/server draw (base, t, 1, j)
  a LoRA factor A   (base, i)

The draws are a pure function of the path, so they stay stateless in
the round index, as the reference's are. Every draw goes through
:func:`permutation` or :func:`normal`; :func:`injected` replaces both
for a ``with`` block, so a test can hand the port the reference's own
permutations and normals for the same paths.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# fn(kind, path, shape) -> array; kind is "permutation" or "normal"
_INJECTED: Optional[Callable] = None


class StreamKey:
    """A point of a keyed stream: its fold path and the device its draws
    land on. ``fold_in(j)`` extends the path, as ``jax.random.fold_in``
    folds a key."""

    __slots__ = ("path", "device")

    def __init__(self, path: Tuple[int, ...], device):
        self.path = tuple(int(p) for p in path)
        self.device = torch.device(device)

    def fold_in(self, j: int) -> "StreamKey":
        return StreamKey(self.path + (int(j),), self.device)

    def generator(self) -> torch.Generator:
        seed = np.random.SeedSequence(self.path).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))


def round_key(base: int, t: int, device) -> StreamKey:
    """The key of round ``t`` of the stream seeded ``base``."""
    return StreamKey((base, t), device)


def stream_key(base: int, device) -> StreamKey:
    """The root key of the stream seeded ``base`` (folded per draw, as
    the LoRA init folds it by the target)."""
    return StreamKey((base,), device)


# the reference's PRNG implementation, as its checkpoints name it
_KEY_IMPL = "threefry2x32"


def key_state(base: int):
    """The JSON form of the root key seeded ``base`` as the reference's
    checkpoints write it (``{"impl", "key_data"}``), so a checkpoint
    crosses packages."""
    return {"impl": _KEY_IMPL, "key_data": [base >> 32, base & 0xFFFFFFFF]}


def base_from_state(state) -> int:
    """The seed of a root key from :func:`key_state`'s form."""
    if state["impl"] != _KEY_IMPL:
        raise ValueError(f"key impl {state['impl']!r}: only {_KEY_IMPL!r} "
                         f"keys are seeded by an integer")
    hi, lo = state["key_data"]
    return (int(hi) << 32) | int(lo)


def permutation(key: StreamKey, n: int) -> torch.Tensor:
    """A permutation of ``range(n)`` (int64) on the key's device."""
    if _INJECTED is not None:
        drawn = _INJECTED("permutation", key.path, (n,))
        return torch.as_tensor(np.array(drawn, np.int64)).to(key.device)
    return torch.randperm(n, generator=key.generator(), device=key.device)


def normal(key: StreamKey, shape) -> torch.Tensor:
    """Standard normals of ``shape`` in fp32 on the key's device."""
    shape = tuple(shape)
    if _INJECTED is not None:
        drawn = _INJECTED("normal", key.path, shape)
        return torch.as_tensor(np.array(drawn, np.float32)).to(key.device)
    return torch.randn(shape, generator=key.generator(), device=key.device,
                       dtype=torch.float32)


@contextlib.contextmanager
def injected(fn: Callable):
    """Within the block every draw is ``fn(kind, path, shape)``, kind
    ``"permutation"`` or ``"normal"``."""
    global _INJECTED
    prev, _INJECTED = _INJECTED, fn
    try:
        yield
    finally:
        _INJECTED = prev
