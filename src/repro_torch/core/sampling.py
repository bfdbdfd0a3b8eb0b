"""Client sampling: uniform without replacement (paper §2).

A copy of the JAX package's host sampler (``core/sampling.py``): numpy
``Generator.choice`` from the trainer's seed, so both packages draw the
same cohorts. The scanned engine's device sampler is not ported yet.
"""
from __future__ import annotations

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
