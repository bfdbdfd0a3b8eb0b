"""Step-size schedules, a copy of the JAX package's ``optim/schedules.py``:
the eta factories and the per-local-step eta_l tables of the
``sgd_sched`` local solver (``core/local_solver.py``), which precomputes
the K values of a round into a ``(K,)`` table and indexes it by step."""
from __future__ import annotations

import math
from typing import List, Tuple


def constant(lr: float):
    """``step -> lr``."""
    return lambda step: lr


def linear_warmup(lr: float, warmup: int):
    """``step -> lr * min(1, (step + 1) / warmup)``."""

    def fn(step):
        return lr * min(1.0, (step + 1) / max(warmup, 1))

    return fn


def cosine_decay(lr: float, total: int, warmup: int = 0, floor: float = 0.0):
    """Linear warmup over ``warmup`` steps, then a half cosine from ``lr``
    down to ``floor`` at step ``total``."""

    def fn(step):
        if step < warmup:
            return lr * (step + 1) / max(warmup, 1)
        t = (step - warmup) / max(total - warmup, 1)
        return floor + (lr - floor) * 0.5 * (1 + math.cos(math.pi * min(t, 1.0)))

    return fn


_LOCAL_SCHEDULES = ("constant", "warmup", "cosine")


def schedule_names() -> Tuple[str, ...]:
    """Names accepted by ``FedRoundSpec.eta_l_schedule``."""
    return _LOCAL_SCHEDULES


def local_eta_table(name: str, eta_l: float, K: int) -> List[float]:
    """The K per-local-step step sizes of one round, as plain floats.

    ``constant`` is exactly eta_l every step; ``warmup`` ramps linearly
    over the first ceil(K/4) steps; ``cosine`` decays from eta_l to its
    floor of 0 endpoint-inclusive over the K steps: step 0 is exactly
    eta_l and step K-1 is exactly 0.0 (the decay horizon is K-1; with K=1
    the single entry stays eta_l).
    """
    if name == "constant":
        fn = constant(eta_l)
    elif name == "warmup":
        fn = linear_warmup(eta_l, max(1, -(-K // 4)))
    elif name == "cosine":
        # horizon K-1, not K, so that step K-1 reaches the floor
        fn = cosine_decay(eta_l, max(K - 1, 1))
    else:
        raise ValueError(
            f"unknown eta_l schedule {name!r}; known: {_LOCAL_SCHEDULES}")
    return [float(fn(t)) for t in range(K)]
