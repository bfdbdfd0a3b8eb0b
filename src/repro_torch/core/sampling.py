"""Client sampling: uniform without replacement (paper §2).

A copy of the JAX package's host sampler (``core/sampling.py``): numpy
``Generator.choice`` from the trainer's seed, so both packages draw the
same cohorts, and its state rides in a checkpoint as the reference's
does. The scanned engine's device sampler is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


class ClientSampler:
    """Host-side uniform without-replacement cohort sampler."""

    def __init__(self, num_clients: int, num_sampled: int, seed: int = 0):
        self.num_clients = num_clients
        self.num_sampled = num_sampled
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        return self._rng.choice(self.num_clients, size=self.num_sampled,
                                replace=False)

    # the numpy bit-generator state, JSON-serializable, for an exact
    # resume of the sampling trajectory (checkpoint/checkpoint.py)
    def get_state(self) -> Dict[str, Any]:
        return self._rng.bit_generator.state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._rng.bit_generator.state = state
