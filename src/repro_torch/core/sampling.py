"""Client sampling: uniform without replacement (paper §2).

Two samplers, as in the JAX package's ``core/sampling.py``:

``ClientSampler``
    The host sampler, a copy of the reference's: numpy
    ``Generator.choice`` from the trainer's seed, so both packages draw
    the same cohorts; its state rides in a checkpoint.

``DeviceClientSampler``
    The scanned engine's sampler. Round ``t``'s cohort is the first S
    of a permutation of ``range(N)`` drawn at the stream path ``(seed,
    t)`` on the device (``device_sample_ids``, ``core.streams``): a
    stateless function of the seed and the absolute round, as the
    reference's ``permutation(fold_in(key, t), N)[:S]`` is, so a chunk
    of rounds, several resumed chunks and a per-round loop draw the same
    cohorts. A checkpoint carries only the seed, in the reference's key
    form.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.core.streams import (
    StreamKey,
    base_from_state,
    key_state,
    permutation,
    stream_key,
)


class ClientSampler:
    """Host-side uniform without-replacement cohort sampler."""

    def __init__(self, num_clients: int, num_sampled: int, seed: int = 0):
        self.num_clients = num_clients
        self.num_sampled = num_sampled
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        return self._rng.choice(self.num_clients, size=self.num_sampled,
                                replace=False)

    def sample_available(self, pool: np.ndarray, size: int) -> np.ndarray:
        """Up to ``size`` clients of the available ``pool``, uniform
        without replacement (the async engine's dispatches). Fewer when
        fewer are available; an empty pool (or ``size <= 0``) consumes no
        randomness. With the full population available and ``size ==
        num_sampled`` it consumes the generator exactly as ``sample()``
        does (``Generator.choice`` treats an int ``n`` and ``arange(n)``
        alike), which keeps the async engine's degenerate limit on the
        synchronous cohorts."""
        pool = np.asarray(pool)
        n = min(int(size), pool.size)
        if n <= 0:
            return np.empty(0, np.int64)
        return self._rng.choice(pool, size=n, replace=False)

    # the numpy bit-generator state, JSON-serializable, for an exact
    # resume of the sampling trajectory (checkpoint/checkpoint.py)
    def get_state(self) -> Dict[str, Any]:
        return self._rng.bit_generator.state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._rng.bit_generator.state = state


def device_sample_ids(key: StreamKey, t: int, num_clients: int,
                      num_sampled: int):
    """Round ``t``'s cohort, ``(S,)`` int64 on the key's device, uniform
    without replacement: the first S of the permutation at
    ``key.fold_in(t)``."""
    return permutation(key.fold_in(t), num_clients)[:num_sampled]


class DeviceClientSampler:
    """The scanned engine's handle on the device cohort stream: its root
    key (``stream_key(seed, device)``), folded by the round in
    :func:`device_sample_ids`, and its checkpoint form."""

    def __init__(self, num_clients: int, num_sampled: int, seed: int = 0,
                 device="cuda"):
        self.num_clients = num_clients
        self.num_sampled = num_sampled
        self.device = device
        self.key = stream_key(seed, device)

    # the stream is stateless in t: the root key is all a checkpoint keeps
    def get_state(self) -> Dict[str, Any]:
        return key_state(self.key.path[0])

    def set_state(self, state: Dict[str, Any]) -> None:
        self.key = stream_key(base_from_state(state), self.device)
