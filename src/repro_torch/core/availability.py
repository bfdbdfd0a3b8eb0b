"""Trace-driven client availability simulation: a copy of the JAX
package's ``core/availability.py`` (numpy, ``heapq`` and ``json`` only),
so the two packages hand out the same fates and events, float for float.

Real federated fleets are stragglers and churn, not synchronous cohorts:
a dispatched client may take arbitrarily long to report back, die
mid-round, or only come online in duty-cycle windows. This module makes
that a *deterministic, wall-clock-free* simulation so the async engine
(``repro_torch.core.async_engine``) is testable and benchmarkable:

``AvailabilityModel``
    Per-client latency / dropout / online-window behaviour. The fate of
    dispatch ``k`` to client ``i`` — ``(latency, dropped)`` — is a pure
    function of ``(model seed, i, k)``: no hidden RNG state advances, so
    any replay (tests, checkpoint resume, the trace recorder) sees
    identical fates regardless of dispatch interleaving. Registered
    under a factory registry mirroring the other pluggable surfaces
    (``register_availability`` / ``make_availability`` /
    ``availability_names``). Built-ins:

      ``always_on``   zero latency, no dropout, everyone available —
                      the sync-equivalence anchor (with ``M=K`` the
                      async engine is bit-for-bit the sync host loop).
      ``uniform``     latency ~ U[lo, hi), optional dropout/duty cycle.
      ``lognormal``   latency = median·exp(sigma·z)·speed_i with a
                      per-client lognormal speed — ``sigma`` is the
                      straggler-tail severity knob the benchmark sweeps.
      ``trace``       replay of a recorded ``AvailabilityTrace``.

``AvailabilityTrace`` / ``RecordingAvailability``
    The replayable trace format: per-dispatch ``(client, k) ->
    (latency, dropped)`` records with a JSON round-trip, captured by
    wrapping any model in ``RecordingAvailability``. Replaying a trace
    through ``TraceAvailability`` reproduces the recorded run exactly
    (held against the reference in tests/test_torch_availability.py).

``DispatchSimulator``
    The virtual-time event core: a monotone clock, a completion-event
    heap, the busy set, and per-client dispatch counters. ``fill()``
    samples new dispatches from the currently-available idle pool
    through ``ClientSampler.sample_available`` — the *same* numpy
    stream as the sync sampler, consumed identically when everyone is
    available — and ``pop()`` advances the clock to the next completion.
    A dropped dispatch still occupies its in-flight slot until its
    (virtual) completion time, but its update is never delivered — the
    fault-injection hook: client dies mid-round, its rows stay
    untouched.
"""
from __future__ import annotations

import heapq
import json
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# availability models + registry
# ---------------------------------------------------------------------------


class AvailabilityModel:
    """Per-client latency/dropout/online-window behaviour.

    ``fate(client, k)`` must be a pure function of (model config, client,
    k): the k-th dispatch to a client always meets the same fate, so
    replays and checkpoint resumes are exact. ``available(ids, t)`` /
    ``next_available(ids, t)`` describe duty-cycle windows in virtual
    time (the base model is always-online)."""

    name: str = ""

    def fate(self, client: int, k: int) -> Tuple[float, bool]:
        """(latency, dropped) of the k-th dispatch to ``client``."""
        return 0.0, False

    def available(self, ids: np.ndarray, t: float) -> np.ndarray:
        """Boolean mask over ``ids``: online at virtual time ``t``?"""
        return np.ones(len(ids), bool)

    def next_available(self, ids: np.ndarray, t: float) -> float:
        """Earliest virtual time > t at which some id comes online
        (``t`` itself if someone already is; ``inf`` if never)."""
        return t


class AlwaysOn(AvailabilityModel):
    """Zero latency, no dropout, everyone always online — the degenerate
    limit in which the async engine equals the sync host loop."""

    name = "always_on"


class SeededAvailability(AvailabilityModel):
    """Shared machinery of the stochastic models: a counter-based
    per-dispatch RNG (``default_rng([salt, seed, client, k])`` — no
    carried state), per-dispatch dropout, and an optional duty-cycle
    online window (client i is online for the first ``duty`` fraction of
    each ``period``, phase-shifted per client)."""

    _SALT = 0x5CAF_F01D

    def __init__(self, seed: int = 0, dropout: float = 0.0,
                 duty: float = 1.0, period: float = 64.0):
        assert 0.0 <= dropout < 1.0, dropout
        assert 0.0 < duty <= 1.0, duty
        assert period > 0.0, period
        self.seed = int(seed)
        self.dropout = float(dropout)
        self.duty = float(duty)
        self.period = float(period)

    # -- the per-dispatch counter-based stream --------------------------

    def _dispatch_rng(self, client: int, k: int) -> np.random.Generator:
        return np.random.default_rng([self._SALT, self.seed, client, k])

    def _latency(self, rng: np.random.Generator, client: int) -> float:
        return 0.0

    def fate(self, client: int, k: int) -> Tuple[float, bool]:
        rng = self._dispatch_rng(client, k)
        latency = float(self._latency(rng, int(client)))
        dropped = bool(self.dropout and rng.random() < self.dropout)
        return latency, dropped

    # -- duty-cycle windows ---------------------------------------------

    def _phases(self, ids: np.ndarray) -> np.ndarray:
        return np.array([
            np.random.default_rng([self._SALT, self.seed, 1, int(i)]).random()
            for i in np.asarray(ids)])

    def available(self, ids: np.ndarray, t: float) -> np.ndarray:
        if self.duty >= 1.0:
            return np.ones(len(ids), bool)
        frac = (t / self.period + self._phases(ids)) % 1.0
        return frac < self.duty

    def next_available(self, ids: np.ndarray, t: float) -> float:
        if self.duty >= 1.0 or len(ids) == 0:
            return t
        online = self.available(ids, t)
        if online.any():
            return t
        # next window start of client i: the smallest t' > t with
        # frac(t'/period + phase_i) == 0
        phases = self._phases(ids)
        n = np.ceil(t / self.period + phases)
        starts = (n - phases) * self.period
        starts = np.where(starts <= t, starts + self.period, starts)
        return float(starts.min())


class UniformLatency(SeededAvailability):
    """Latency ~ U[lo, hi) per dispatch — a flat, tail-free baseline."""

    name = "uniform"

    def __init__(self, seed: int = 0, lo: float = 0.5, hi: float = 1.5,
                 dropout: float = 0.0, duty: float = 1.0,
                 period: float = 64.0):
        super().__init__(seed, dropout, duty, period)
        assert 0.0 <= lo <= hi, (lo, hi)
        self.lo, self.hi = float(lo), float(hi)

    def _latency(self, rng, client):
        return self.lo + (self.hi - self.lo) * rng.random()


class LogNormalLatency(SeededAvailability):
    """Heavy-tailed latency: ``median * exp(sigma * z_k) * speed_i``
    with a per-client lognormal speed factor (slow devices stay slow).
    ``sigma`` is the straggler-tail severity knob bench_async sweeps."""

    name = "lognormal"

    def __init__(self, seed: int = 0, median: float = 1.0,
                 sigma: float = 1.0, client_sigma: float = 0.5,
                 dropout: float = 0.0, duty: float = 1.0,
                 period: float = 64.0):
        super().__init__(seed, dropout, duty, period)
        assert median > 0.0, median
        self.median = float(median)
        self.sigma = float(sigma)
        self.client_sigma = float(client_sigma)

    def _speed(self, client: int) -> float:
        z = np.random.default_rng(
            [self._SALT, self.seed, 2, int(client)]).standard_normal()
        return float(np.exp(self.client_sigma * z))

    def _latency(self, rng, client):
        return self.median * float(
            np.exp(self.sigma * rng.standard_normal())) * self._speed(client)


# ---------------------------------------------------------------------------
# the replayable trace format
# ---------------------------------------------------------------------------


class AvailabilityTrace:
    """Recorded per-dispatch fates: ``(client, k) -> (latency, dropped)``,
    with a JSON round-trip so scenarios are reproducible artifacts."""

    def __init__(self, records: Optional[Dict[Tuple[int, int],
                                              Tuple[float, bool]]] = None):
        self.records: Dict[Tuple[int, int], Tuple[float, bool]] = (
            dict(records) if records else {})

    def record(self, client: int, k: int, latency: float,
               dropped: bool) -> None:
        self.records[(int(client), int(k))] = (float(latency), bool(dropped))

    def __len__(self) -> int:
        return len(self.records)

    def to_json(self) -> str:
        rows = [[c, k, lat, drop]
                for (c, k), (lat, drop) in sorted(self.records.items())]
        return json.dumps({"format": "availability-trace/v1",
                           "records": rows})

    @classmethod
    def from_json(cls, text: str) -> "AvailabilityTrace":
        payload = json.loads(text)
        assert payload.get("format") == "availability-trace/v1", (
            f"not an availability trace: {payload.get('format')!r}")
        tr = cls()
        for c, k, lat, drop in payload["records"]:
            tr.record(c, k, lat, drop)
        return tr

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "AvailabilityTrace":
        with open(path) as f:
            return cls.from_json(f.read())


class TraceAvailability(AvailabilityModel):
    """Replay a recorded trace: the k-th dispatch to client i meets
    exactly the recorded fate; an unrecorded dispatch is a loud error
    (the replay diverged from the recorded run)."""

    name = "trace"

    def __init__(self, trace: "AvailabilityTrace | str"):
        if isinstance(trace, str):
            trace = AvailabilityTrace.load(trace)
        self.trace = trace

    def fate(self, client, k):
        try:
            return self.trace.records[(int(client), int(k))]
        except KeyError:
            raise KeyError(
                f"availability trace has no record for dispatch k={k} to "
                f"client {client}: the replayed run diverged from the "
                f"recorded one (different sampler seed / engine config?)"
            ) from None


class RecordingAvailability(AvailabilityModel):
    """Wrap any model and record every fate it hands out; ``.trace`` is
    then replayable through ``TraceAvailability``."""

    name = "recording"

    def __init__(self, inner: AvailabilityModel):
        self.inner = inner
        self.trace = AvailabilityTrace()

    def fate(self, client, k):
        latency, dropped = self.inner.fate(client, k)
        self.trace.record(client, k, latency, dropped)
        return latency, dropped

    def available(self, ids, t):
        return self.inner.available(ids, t)

    def next_available(self, ids, t):
        return self.inner.next_available(ids, t)


_AVAILABILITY: Dict[str, Callable[..., AvailabilityModel]] = {}


def register_availability(name: str,
                          factory: Callable[..., AvailabilityModel]) -> None:
    """Register an availability-model *factory* (models own config)."""
    assert name, "availability models must be registered under a name"
    _AVAILABILITY[name] = factory


def make_availability(name: str, **kwargs) -> AvailabilityModel:
    """Build a registered availability model; unknown names fail loudly."""
    try:
        factory = _AVAILABILITY[name]
    except KeyError:
        raise KeyError(
            f"unknown availability model {name!r}; registered: "
            f"{availability_names()}") from None
    return factory(**kwargs)


def availability_names() -> Tuple[str, ...]:
    """Sorted names of all registered availability models."""
    return tuple(sorted(_AVAILABILITY))


register_availability("always_on", AlwaysOn)
register_availability("uniform", UniformLatency)
register_availability("lognormal", LogNormalLatency)
register_availability("trace", TraceAvailability)


# ---------------------------------------------------------------------------
# the virtual-time event core
# ---------------------------------------------------------------------------


class Dispatch(NamedTuple):
    """One server->client dispatch: fated at creation (``fate(client,
    k)``), delivered (or dropped) at ``complete_t`` virtual time."""

    seq: int
    client: int
    k: int          # this client's dispatch counter (the trace key)
    time: float     # dispatch (virtual) time
    latency: float
    dropped: bool
    complete_t: float


class DispatchSimulator:
    """Virtual clock + completion-event heap + busy set.

    ``fill()`` dispatches to as many currently-available idle clients as
    there are free in-flight slots, sampling them through
    ``sampler.sample_available`` — the same numpy stream as the sync
    cohort sampler, consumed identically when the full population is
    available. ``pop()`` returns the next completion in (complete_t,
    seq) order and advances the clock to it; ties (equal completion
    times) resolve in dispatch order, which is what makes the
    zero-latency limit replay the sync loop's cohort order exactly.

    Entirely wall-clock-free: given (model, sampler seed, max_inflight)
    the event sequence is a deterministic replayable function — the
    property tests drive it standalone."""

    def __init__(self, model: AvailabilityModel, sampler, num_clients: int,
                 max_inflight: int):
        assert max_inflight >= 1, max_inflight
        self.model = model
        self.sampler = sampler
        self.num_clients = int(num_clients)
        self.max_inflight = int(max_inflight)
        self.clock = 0.0
        self.seq = 0
        self.dispatch_k = np.zeros(self.num_clients, np.int64)
        self._busy: set = set()
        self._heap: List[Tuple[float, int, Dispatch]] = []

    # -- state views ----------------------------------------------------

    def pending(self) -> int:
        return len(self._heap)

    def inflight_clients(self) -> Tuple[int, ...]:
        return tuple(sorted(self._busy))

    def next_time(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def should_fill(self) -> bool:
        """Dispatch new work only when no already-completed event is
        waiting: all completions at the current instant drain before new
        dispatches sample the stream — the ordering that keeps the
        zero-latency limit on the sync sampler trajectory."""
        return (len(self._busy) < self.max_inflight
                and (not self._heap or self._heap[0][0] > self.clock))

    # -- event loop -----------------------------------------------------

    def _idle_ids(self) -> np.ndarray:
        idle = np.arange(self.num_clients)
        if self._busy:
            idle = np.setdiff1d(
                idle, np.fromiter(self._busy, np.int64, len(self._busy)),
                assume_unique=True)
        return idle

    def fill(self) -> List[Dispatch]:
        """Dispatch to up to (max_inflight - busy) available idle
        clients; returns the new dispatches (possibly none)."""
        free = self.max_inflight - len(self._busy)
        if free <= 0:
            return []
        idle = self._idle_ids()
        if len(idle) == 0:
            return []
        mask = np.asarray(self.model.available(idle, self.clock), bool)
        pool = idle[mask]
        ids = self.sampler.sample_available(pool, free)
        out = []
        for c in ids:
            c = int(c)
            k = int(self.dispatch_k[c])
            self.dispatch_k[c] += 1
            latency, dropped = self.model.fate(c, k)
            latency = float(latency)
            assert latency >= 0.0, (c, k, latency)
            d = Dispatch(self.seq, c, k, self.clock, latency, bool(dropped),
                         self.clock + latency)
            self.seq += 1
            self._busy.add(c)
            heapq.heappush(self._heap, (d.complete_t, d.seq, d))
            out.append(d)
        return out

    def pop(self) -> Dispatch:
        """Next completion in (complete_t, seq) order; advances the
        clock (monotone) and frees the client's in-flight slot."""
        t, _, d = heapq.heappop(self._heap)
        self.clock = t
        self._busy.discard(d.client)
        return d

    def advance_to_available(self) -> None:
        """Nothing in flight and nobody online: jump the clock to the
        next availability window. Loud error when the model can never
        produce one (otherwise the event loop would spin forever)."""
        t_next = float(self.model.next_available(self._idle_ids(), self.clock))
        if not math.isfinite(t_next) or t_next <= self.clock:
            raise RuntimeError(
                f"availability model {self.model.name!r} starved the "
                f"simulator at t={self.clock}: nothing in flight, no client "
                f"available, and no future availability window")
        self.clock = t_next

    # -- checkpoint support (core/async_engine.py) ----------------------

    def restore(self, clock: float, seq: int, dispatch_k: np.ndarray,
                inflight: List[Dispatch]) -> None:
        """Rebuild the event state from checkpointed scalars + the
        engine's restored in-flight dispatch records."""
        self.clock = float(clock)
        self.seq = int(seq)
        self.dispatch_k = np.asarray(dispatch_k, np.int64).copy()
        self._busy = {d.client for d in inflight}
        self._heap = [(d.complete_t, d.seq, d) for d in inflight]
        heapq.heapify(self._heap)


def record_trace(model: AvailabilityModel) -> RecordingAvailability:
    """Convenience: wrap ``model`` so every fate is captured into a
    replayable ``AvailabilityTrace`` (``wrapper.trace``)."""
    return RecordingAvailability(model)
