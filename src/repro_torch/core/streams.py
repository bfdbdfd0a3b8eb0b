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

The scanned engine draws at the same kind of paths: a round's cohort
at ``(seed, t)`` and its data at ``(seed + 1, t)`` (the synthetic LM's
three draws at ``(seed + 1, t, j)``, where the reference splits that key
in three).

The draws are a pure function of the path, so they stay stateless in
the round index, as the reference's are. Every draw goes through
:func:`permutation`, :func:`normal`, :func:`uniform` or
:func:`categorical`; :func:`injected` replaces them for a ``with``
block, so a test can hand the port the reference's own draws for the
same paths.

:class:`DrawAhead` draws a chunk of rounds up front into device
buffers, one row a round, and serves a round its row: a round captured
once as a CUDA graph then reads its draws from fixed addresses, while
every draw stays the function of its path that it is in a round run
alone (see ``core.controller``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# fn(kind, path, shape) -> array; kind is "permutation", "normal",
# "uniform" or "categorical"
_INJECTED: Optional[Callable] = None
# the DrawAhead that serves the draws of the round in progress in this
# thread (its ``ahead`` attribute, None outside a round): a store worker
# that plans cohorts draws at its own paths while a round runs
_ROUND = threading.local()


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


def _float(kind: str) -> bool:
    """Whether draws of ``kind`` are fp32 (else int64 indices)."""
    return kind in ("normal", "uniform")


def _draw(kind: str, key: StreamKey, shape, logits=None) -> torch.Tensor:
    """One draw at the key's path on its device, or the injected one."""
    if _INJECTED is not None:
        drawn = _INJECTED(kind, key.path, shape)
        return torch.as_tensor(np.array(
            drawn, np.float32 if _float(kind) else np.int64)).to(key.device)
    gen = key.generator()
    if kind == "permutation":
        return torch.randperm(shape[0], generator=gen, device=key.device)
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=key.device,
                           dtype=torch.float32)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=key.device,
                          dtype=torch.float32)
    # the inverse of a float64 CDF summed on the host: the same indices at
    # every run (a device cumsum, as torch.multinomial's, adds in an order
    # that can vary from run to run on the card)
    cdf = torch.cumsum(logits.detach().cpu().double().exp(), 0)
    u = torch.rand(math.prod(shape), generator=gen, device=key.device,
                   dtype=torch.float64)
    idx = torch.searchsorted(cdf.to(key.device) / cdf[-1].item(), u,
                             right=True)
    return idx.clamp_(max=logits.numel() - 1).reshape(shape)


def _take(kind: str, key: StreamKey, shape, logits=None) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    ahead = getattr(_ROUND, "ahead", None)
    if ahead is not None:
        return ahead.serve(kind, key, shape, logits)
    return _draw(kind, key, shape, logits)


def permutation(key: StreamKey, n: int) -> torch.Tensor:
    """A permutation of ``range(n)`` (int64) on the key's device."""
    return _take("permutation", key, (n,))


def normal(key: StreamKey, shape) -> torch.Tensor:
    """Standard normals of ``shape`` in fp32 on the key's device."""
    return _take("normal", key, shape)


def uniform(key: StreamKey, shape) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` in fp32 on the key's device."""
    return _take("uniform", key, shape)


def categorical(key: StreamKey, logits: torch.Tensor, shape) -> torch.Tensor:
    """Indices (int64) of ``shape``, each drawn from the categorical of
    the 1-D ``logits`` (unnormalised log-probabilities)."""
    return _take("categorical", key, shape, logits)


class DrawAhead:
    """Every keyed draw of a round, drawn ahead for up to ``capacity``
    rounds into device buffers, and served to the round in progress from
    the row that the 1-element int64 ``slot`` (on the device) names.

    A round's draws are all at paths ``(base, t, ...)``. The first round
    run under :meth:`serving` draws at its own paths and records each
    draw's kind, its path with ``t`` left out, its shape (and a
    categorical's logits); :meth:`allocate` then makes one
    ``(capacity, *shape)`` buffer a draw. :meth:`fill` draws rounds ``t0``
    to ``t0 + n - 1`` at their own paths into rows 0 to n - 1, by the
    same functions a round run alone draws with, so a chunk reads the
    draws of its rounds bit for bit, whatever its length. The round that
    reads row ``slot`` advances ``slot`` itself (on the device); the
    caller zeroes it before a chunk. A draw that the first round did not
    make raises."""

    def __init__(self, capacity: int, device):
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.slot = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.entries: Optional[dict] = None  # (kind, rel) -> (shape, logits)
        self.bufs: dict = {}
        self._recording_t: Optional[int] = None

    @property
    def recorded(self) -> bool:
        return self.entries is not None

    def round_bytes(self) -> int:
        """Bytes of one round's draws."""
        return sum((4 if _float(kind) else 8) * math.prod(shape)
                   for (kind, _), (shape, _) in self.entries.items())

    @contextlib.contextmanager
    def serving(self, t: int):
        """Within the block every draw of the round ``t`` is served from
        the buffers (recorded and drawn at its path, in the first
        round); in this thread only."""
        if self.entries is None:
            self.entries, self._recording_t = {}, int(t)
        prev, _ROUND.ahead = getattr(_ROUND, "ahead", None), self
        try:
            yield
        finally:
            _ROUND.ahead = prev
            self._recording_t = None

    def serve(self, kind, key: StreamKey, shape, logits=None):
        path = key.path
        if len(path) < 2:
            raise RuntimeError(f"a draw at path {path} inside a round: a "
                               f"round's draws are keyed by its index")
        rel = (kind, (path[0],) + path[2:])
        if self._recording_t is not None:
            if path[1] != self._recording_t:
                raise RuntimeError(f"draw at {path} in round "
                                   f"{self._recording_t}")
            self.entries[rel] = (shape, logits)
            return _draw(kind, key, shape, logits)
        buf = self.bufs.get(rel)
        if buf is None or tuple(buf.shape[1:]) != shape:
            raise RuntimeError(
                f"{kind} draw at {path} of shape {shape}: the round's first "
                f"run did not make it; its draws are recorded then")
        return buf.index_select(0, self.slot)[0]

    def allocate(self, capacity: Optional[int] = None) -> None:
        """Make the buffers of the recorded draws, ``capacity`` rows each
        (the constructor's by default)."""
        if capacity is not None:
            self.capacity = int(capacity)
        self.bufs = {}
        for (kind, rel), (shape, _) in self.entries.items():
            self.bufs[(kind, rel)] = torch.empty(
                (self.capacity,) + shape, device=self.device,
                dtype=torch.float32 if _float(kind) else torch.int64)

    def fill(self, t0: int, n: int) -> None:
        """Draw rounds ``t0 .. t0 + n - 1`` into rows ``0 .. n - 1``."""
        if not 1 <= n <= self.capacity:
            raise ValueError(f"fill of {n} rounds into {self.capacity} rows")
        for (kind, rel), (shape, logits) in self.entries.items():
            buf = self.bufs[(kind, rel)]
            for r in range(n):
                key = StreamKey((rel[0], t0 + r) + rel[1:], self.device)
                buf[r].copy_(_draw(kind, key, shape, logits))


@contextlib.contextmanager
def injected(fn: Callable):
    """Within the block every draw is ``fn(kind, path, shape)``, kind
    ``"permutation"``, ``"normal"``, ``"uniform"`` or ``"categorical"``
    (the int64 indices of ``shape``)."""
    global _INJECTED
    prev, _INJECTED = _INJECTED, fn
    try:
        yield
    finally:
        _INJECTED = prev
