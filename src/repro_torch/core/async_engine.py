"""FedBuff-style asynchronous buffered aggregation (the JAX package's
``core/async_engine.py``): the fourth execution mode.

The synchronous engines dispatch one S-client cohort and wait for all
of it. Here the server keeps up to ``max_inflight`` (K) dispatches
outstanding against the clients the availability model
(``core/availability.py``) says are online, buffers completed updates as
they land (out of order, possibly computed against an older broadcast)
and applies one ``ServerOptimizer`` step once ``buffer_size`` (M) of
them have arrived. Each buffered update is weighted by its staleness
τ = current version - dispatch version through a ``StalenessWeighting``
(``constant``, ``polynomial`` 1/(1+τ)^a, ``cutoff``; a registry like the
other strategy surfaces).

It is a discrete-event simulation in virtual time: nothing runs
concurrently on the card. A dispatch group's clients run eagerly when
they are dispatched, one after another through the round's own client
block (``core.rounds.client_block``: ``client_update``, clip, client
noise, uplink round trip), from the version's broadcast (the downlink
codec's ``apply_stateless`` at ``(comp_base, version, 1)``, computed
once a version). Client ``position = dispatches made at this version``
draws its codec and noise keys at ``(comp_base, version, 0, position)``
and ``(priv_base, version, 0, position)``.

A pending update keeps its ``dy`` and ``dc`` on the trainer's device
(the aggregation reads them there) and its new ``c_i``, residual and
solver-slot rows on the host, as the synchronous round writes them: rows
of the dispatch group's own gathered copies, which nothing else writes.
They reach the trainer's stores at *delivery* (``scatter_async`` on a
``TieredClientStore``, ``scatter`` otherwise), one row a completed
dispatch; a dropped dispatch (the client died mid-round) writes nothing.

The aggregation replays the synchronous round's arithmetic: the buffer's
deltas summed in fp32 in delivery order (``rounds._accumulate``), then
``a / M`` rounded once to the tree's dtype; with non-uniform weights (a
staleness weighting other than ``constant``, or weighted aggregation)
the normalised fp32 weighted sum, the staleness weights folded in. Then
server noise at ``(priv_base, version, 1)``, the server optimizer and the
control update; drift is the mean of the buffered post-codec norms.

So with ``M = K = num_sampled``, ``always_on`` and ``constant``, the
engine is bit for bit ``FederatedTrainer(pipeline_depth=0)``: the same
server state, store rows and metrics, since ``sample_available`` over the
whole idle population draws as ``sample()`` does and everything else is
the same code in the same order.

History entries carry the synchronous keys (loss, drift, update_norm,
exact-int bytes_up and bytes_down, round, dp_epsilon) and the async
block: the staleness histogram, mean buffer occupancy, in-flight count,
dispatched and dropped counts, virtual time and simulated rounds/s.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import (
    ClientRoundState,
    ServerState,
    get_algorithm,
    get_server_optimizer,
    resolve_server_optimizer,
)
from repro_torch.core.availability import (
    AvailabilityModel,
    Dispatch,
    DispatchSimulator,
    make_availability,
)
from repro_torch.core.compression import get_compressor, round_comm_bytes
from repro_torch.core.local_solver import get_local_solver, resolve_local_solver
from repro_torch.core.privatizer import get_privatizer
from repro_torch.core.rounds import _accumulate, client_block
from repro_torch.core.store import TieredClientStore
from repro_torch.core.streams import round_key
from repro_torch.core.tree import tree_map, tree_norm

# ---------------------------------------------------------------------------
# staleness weighting and its registry
# ---------------------------------------------------------------------------


class StalenessWeighting:
    """Weight of a buffered update as a function of its staleness τ
    (aggregations since its dispatch). ``uniform=True`` declares the
    weights constant, so the engine takes the synchronous round's
    unweighted mean (the bitwise degenerate limit)."""

    name: str = ""
    uniform: bool = False

    def weights(self, tau: torch.Tensor) -> torch.Tensor:
        """(M,) fp32 staleness values -> (M,) unnormalised fp32 weights,
        on tau's device."""
        raise NotImplementedError


class ConstantWeighting(StalenessWeighting):
    """FedBuff's plain buffered mean: staleness-blind."""

    name = "constant"
    uniform = True

    def weights(self, tau):
        return torch.ones_like(tau)


class PolynomialWeighting(StalenessWeighting):
    """``1 / (1 + τ)^alpha``, the polynomial staleness decay (alpha 0.5
    is FedBuff's default)."""

    name = "polynomial"

    def __init__(self, alpha: float = 0.5):
        assert alpha >= 0.0, alpha
        self.alpha = float(alpha)

    def weights(self, tau):
        return 1.0 / (1.0 + tau) ** self.alpha


class CutoffWeighting(StalenessWeighting):
    """Weight 1 for τ <= cutoff, else 0. An all-stale buffer normalises
    to a zero step: the aggregation is a no-op, not an error."""

    name = "cutoff"

    def __init__(self, cutoff: float = 10.0):
        assert cutoff >= 0.0, cutoff
        self.cutoff = float(cutoff)

    def weights(self, tau):
        return torch.where(tau <= self.cutoff, torch.ones_like(tau),
                           torch.zeros_like(tau))


_STALENESS: Dict[str, Callable[..., StalenessWeighting]] = {}


def register_staleness_weighting(
        name: str, factory: Callable[..., StalenessWeighting]) -> None:
    """Register a staleness-weighting *factory* under ``name``."""
    assert name, "staleness weightings must be registered under a name"
    _STALENESS[name] = factory


def make_staleness_weighting(name: str, **kwargs) -> StalenessWeighting:
    """Build a registered staleness weighting; unknown names fail loudly."""
    try:
        factory = _STALENESS[name]
    except KeyError:
        raise KeyError(
            f"unknown staleness weighting {name!r}; registered: "
            f"{staleness_weighting_names()}") from None
    return factory(**kwargs)


def staleness_weighting_names() -> Tuple[str, ...]:
    """Sorted names of all registered staleness weightings."""
    return tuple(sorted(_STALENESS))


register_staleness_weighting("constant", ConstantWeighting)
register_staleness_weighting("polynomial", PolynomialWeighting)
register_staleness_weighting("cutoff", CutoffWeighting)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class _Pending:
    """One dispatched update not yet aggregated: its dispatch record, the
    version it was computed against, its aggregation size, its deltas on
    the device, its loss and clip flag (0-d), and its new client rows on
    the host by family (``c_i``, ``residual``, ``solver``)."""

    __slots__ = ("dispatch", "version", "size", "dy", "dc", "loss",
                 "clipped", "rows")

    def __init__(self, dispatch: Dispatch, version: int, size: float, dy,
                 dc, loss, clipped, rows: Dict[str, Any]):
        self.dispatch = dispatch
        self.version = version
        self.size = size
        self.dy = dy
        self.dc = dc
        self.loss = loss
        self.clipped = clipped
        self.rows = rows

    def payload(self, key: str):
        """The checkpoint payload under ``key`` (the reference's names)."""
        if key in ("dy", "dc", "loss", "clipped"):
            return getattr(self, key)
        return self.rows[key]


def _row(rows, i: int):
    """Row ``i`` of a family of ``(g, ...)`` rows (views)."""
    return {k: v[i] for k, v in rows.items()}


class AsyncBufferedEngine:
    """Buffered-asynchronous execution of a ``FederatedTrainer``, built by
    the trainer when ``async_buffer=M`` is set; driven through
    ``trainer.run_round()`` / ``trainer.run()``, one round an
    aggregation."""

    def __init__(self, trainer, *, buffer_size: int, max_inflight: int = 0,
                 availability: "str | AvailabilityModel" = "always_on",
                 availability_kwargs: Optional[Dict[str, Any]] = None,
                 staleness_weighting: "str | StalenessWeighting" = "constant",
                 staleness_kwargs: Optional[Dict[str, Any]] = None):
        spec = trainer.spec
        # the trainer owns the engine: a proxy, so the two make no
        # reference cycle (a closed trainer's device tensors go with it)
        self.trainer = weakref.proxy(trainer)
        self.spec = spec
        self.algo = get_algorithm(spec.algorithm)
        if self.algo.whole_batch:
            raise ValueError(
                f"async_buffer does not support the whole-batch baseline "
                f"({spec.algorithm!r}): there is no per-client update to "
                f"buffer")
        if spec.strategy != "client_parallel":
            raise ValueError(
                "async_buffer requires strategy='client_parallel' (a "
                "dispatch group runs its clients as the parallel round does)")
        self.buffer_size = int(buffer_size)
        self.max_inflight = int(max_inflight) or spec.num_sampled
        assert self.buffer_size >= 1, buffer_size
        assert self.max_inflight >= self.buffer_size, (
            f"max_inflight={self.max_inflight} < buffer_size="
            f"{self.buffer_size}: the buffer could never fill")
        self.model = (availability if isinstance(availability,
                                                 AvailabilityModel)
                      else make_availability(availability,
                                             **(availability_kwargs or {})))
        self.weighting = (
            staleness_weighting
            if isinstance(staleness_weighting, StalenessWeighting)
            else make_staleness_weighting(staleness_weighting,
                                          **(staleness_kwargs or {})))
        self.up = get_compressor(spec.compress)
        self.down = get_compressor(spec.compress_downlink)
        self.solver = get_local_solver(resolve_local_solver(spec))
        self.priv = get_privatizer(spec.privatizer)
        self.sim = DispatchSimulator(self.model, trainer.sampler,
                                     spec.num_clients, self.max_inflight)
        # exact wire bytes a client, from the sync round's S-client totals
        rb = round_comm_bytes(spec, trainer.server.x,
                              stateful_clients=self.algo.stateful_clients)
        self._round_bytes_up = int(rb["bytes_up"])
        self._round_bytes_down = int(rb["bytes_down"])

        self.version = 0                            # aggregations applied
        self._inflight: Dict[int, _Pending] = {}    # seq -> pending
        self._buffer: List[_Pending] = []
        self.dropped_total = 0
        self._delivered_since = 0
        self._dropped_since = 0
        self._dispatched_since = 0
        self._occ_sum = 0
        self._occ_n = 0
        self._ver_positions = 0   # dispatches made at the current version
        self._last_agg_clock = 0.0
        self._bcast: Optional[Tuple[int, Any, Any]] = None
        self._idle_advances = 0

    # -- dispatch / deliver / aggregate ---------------------------------------

    def _broadcast(self):
        """The ``(x, c)`` this version's dispatches receive: the downlink
        codec's broadcast at ``(comp_base, version, 1)``, once a
        version."""
        if self._bcast is not None and self._bcast[0] == self.version:
            return self._bcast[1], self._bcast[2]
        tr = self.trainer
        x, c = tr.server.x, tr.server.c
        if self.down.name == "none":
            x_cl, c_cl = x, c
        else:
            key = round_key(tr._comp_seed, self.version, tr.device).fold_in(1)
            x_cl, c_cl = self.down.apply_stateless(self.spec, (x, c), key=key)
        self._bcast = (self.version, x_cl, c_cl)
        return x_cl, c_cl

    def _fill(self) -> int:
        """Dispatch to newly available clients (up to the free in-flight
        slots) and run their client phases now, against this version's
        broadcast. The host RNG order is the sync loop's: the sampler's
        draw, the gathers, then ``round_batches`` on the data stream."""
        dispatches = self.sim.fill()
        if not dispatches:
            return 0
        tr, spec = self.trainer, self.spec
        dev = tr.device
        g = len(dispatches)
        ids = np.fromiter((d.client for d in dispatches), np.int64, g)
        self._dispatched_since += g
        x_cl, c_cl = self._broadcast()
        # copy-on-gather: the group owns these rows, and its clients' new
        # rows are written over them
        rows = ClientRoundState(
            c_i=tr.store.gather(ids),
            uplink_residual=(tr.residual_store.gather(ids)
                             if tr.residual_store is not None else None),
            solver_slots=(tr.solver_store.gather(ids)
                          if tr.solver_store is not None else None))
        sizes = None
        if spec.weighted_aggregation:
            sizes = np.asarray(tr.dataset.client_sizes(ids), np.float32)
        batches = tr.dataset.round_batches(ids, spec.local_steps,
                                           spec.local_batch, tr._rng,
                                           device=dev)
        k_up = round_key(tr._comp_seed, self.version, dev).fold_in(0)
        k_priv = round_key(tr._priv_seed, self.version, dev).fold_in(0)
        fresh_slots = rows.solver_slots is None
        outs = []
        for i in range(g):
            rows, dy, dc, loss, flag = client_block(
                tr._grad_fn, spec, x_cl, c_cl, rows, i,
                {k: v[i] for k, v in batches.items()},
                fresh_slots=fresh_slots, dev=dev, k_up=k_up, k_priv=k_priv,
                position=self._ver_positions + i,
                use_fused_update=tr._use_fused_update)
            outs.append((dy, dc, loss, flag))
        del batches
        self._ver_positions += g
        for i, (d, (dy, dc, loss, flag)) in enumerate(zip(dispatches, outs)):
            fams = {"c_i": _row(rows.c_i, i)}
            if self.up.stateful:
                fams["residual"] = _row(rows.uplink_residual, i)
            if self.solver.stateful:
                fams["solver"] = _row(rows.solver_slots, i)
            self._inflight[d.seq] = _Pending(
                d, self.version,
                float(sizes[i]) if sizes is not None else 1.0,
                dy, dc, loss, flag, fams)
        return g

    @staticmethod
    def _scatter_row(store, ids1, row) -> None:
        one = {k: v[None] for k, v in row.items()}
        if isinstance(store, TieredClientStore):
            store.scatter_async(ids1, one)
        else:
            store.scatter(ids1, one)

    def _deliver(self, p: _Pending) -> None:
        """A dispatch completed: write its c_i, residual and slot rows to
        the stores and buffer its update."""
        tr = self.trainer
        ids1 = np.array([p.dispatch.client], np.int64)
        if self.algo.stateful_clients:
            self._scatter_row(tr.store, ids1, p.rows["c_i"])
        if tr.residual_store is not None:
            self._scatter_row(tr.residual_store, ids1, p.rows["residual"])
        if tr.solver_store is not None:
            self._scatter_row(tr.solver_store, ids1, p.rows["solver"])
        self._buffer.append(p)
        self._delivered_since += 1
        self._occ_sum += len(self._buffer)
        self._occ_n += 1

    def _aggregate(self) -> Dict[str, Any]:
        """One server step over the M buffered updates; appends and
        returns the history entry."""
        tr, spec, buf = self.trainer, self.spec, self._buffer
        self._buffer = []
        dev = tr.device
        x, c = tr.server.x, tr.server.c
        tau_np = np.array([self.version - p.version for p in buf], np.int64)
        if self.weighting.uniform and not spec.weighted_aggregation:
            w_seq, div = [1.0] * len(buf), float(len(buf))
        else:
            w = self.weighting.weights(
                torch.as_tensor(tau_np, dtype=torch.float32, device=dev))
            if spec.weighted_aggregation:
                w = w * torch.tensor([p.size for p in buf],
                                     dtype=torch.float32, device=dev)
            w_seq = list((w / torch.clamp(w.sum(), min=1e-12)).unbind())
            div = 1.0
        # the sync round's fp32 sums, in delivery order
        dy_acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in x.items()}
        dc_acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in c.items()}
        norms = []
        for w, p in zip(w_seq, buf):
            norms.append(tree_norm(p.dy))
            _accumulate(dy_acc, w, p.dy)
            _accumulate(dc_acc, w, p.dc)
            p.dy = p.dc = None
        dy_mean = tree_map(lambda a, xx: (a / div).to(xx.dtype), dy_acc, x)
        dc_mean = tree_map(lambda a, cc: (a / div).to(cc.dtype), dc_acc, c)
        del dy_acc, dc_acc
        drift = torch.stack(norms).mean()
        loss = torch.stack([p.loss for p in buf]).mean()
        privatizing = self.priv.name != "none"
        if privatizing and self.priv.noise_at == "server":
            dy_mean = self.priv.server_noise(
                spec, dy_mean,
                round_key(tr._priv_seed, self.version, dev).fold_in(1))
        clip_frac = None
        if privatizing and self.priv.clips:
            clip_frac = torch.stack([p.clipped for p in buf]).mean()
        opt = get_server_optimizer(resolve_server_optimizer(spec))
        x_new, opt_state_new, applied = opt.apply(spec, tr.server.opt_state,
                                                  x, dy_mean)
        c_new = self.algo.server_control_update(spec, c, dc_mean)
        del dy_mean, dc_mean
        out = {"loss": float(loss), "drift": float(drift),
               "update_norm": float(tree_norm(applied))}
        del applied
        tr.server = ServerState(x=x_new, c=c_new, opt_state=opt_state_new)
        self.version += 1
        tr.round_idx = self.version
        self._ver_positions = 0
        self._bcast = None

        S = spec.num_sampled
        # exact wire bytes since the previous aggregation (a client's
        # bytes = the sync round's S-client totals / S)
        out["bytes_up"] = float(
            self._delivered_since * self._round_bytes_up // S)
        out["bytes_down"] = float(
            self._dispatched_since * self._round_bytes_down // S)
        if privatizing:
            out["dp_epsilon"] = self.priv.epsilon(spec, self.version)
            if clip_frac is not None:
                out["dp_clipped_frac"] = float(clip_frac)
        out["round"] = self.version
        out["staleness_mean"] = float(tau_np.mean())
        out["staleness_max"] = int(tau_np.max())
        out["staleness_hist"] = np.bincount(tau_np).tolist()
        out["buffer_occupancy"] = self._occ_sum / max(self._occ_n, 1)
        out["inflight"] = len(self._inflight)
        out["dispatched"] = self._dispatched_since
        out["dropped"] = self._dropped_since
        out["dropped_total"] = self.dropped_total
        out["sim_time"] = self.sim.clock
        dt = self.sim.clock - self._last_agg_clock
        out["sim_rounds_per_s"] = (1.0 / dt) if dt > 0 else 0.0
        self._delivered_since = 0
        self._dropped_since = 0
        self._dispatched_since = 0
        self._occ_sum = self._occ_n = 0
        self._last_agg_clock = self.sim.clock
        if tr.megakernel_fallback_reason is not None:
            out["megakernel_fallback_reason"] = tr.megakernel_fallback_reason
        if tr.update_space.trains_subset:
            out["update_space"] = tr.update_space.name
        tr.history.append(out)
        return out

    def step(self) -> Optional[Dict[str, Any]]:
        """One event of the simulation: dispatch if due, then the next
        completion (or, with nothing in flight and nobody dispatchable, a
        jump to the next availability window). Returns the history entry
        when the completion filled the buffer and an aggregation fired,
        else None (a checkpoint may be taken between steps)."""
        sim = self.sim
        if sim.should_fill():
            if self._fill():
                self._idle_advances = 0
        if not sim.pending():
            # a loud error if the model never brings anyone online
            sim.advance_to_available()
            self._idle_advances += 1
            if self._idle_advances > 100_000:
                raise RuntimeError(
                    "async engine made no dispatch across 100000 "
                    "availability windows — availability model starves "
                    "the fleet")
            return None
        d = sim.pop()
        p = self._inflight.pop(d.seq)
        if d.dropped:
            # the update never arrives; its rows stay untouched
            self.dropped_total += 1
            self._dropped_since += 1
            return None
        self._deliver(p)
        if len(self._buffer) >= self.buffer_size:
            return self._aggregate()
        return None

    def run_round(self) -> Dict[str, Any]:
        """Advance virtual time until one aggregation fires."""
        self._idle_advances = 0
        while True:
            out = self.step()
            if out is not None:
                return out

    def close(self) -> None:
        """Forget every pending update (their device deltas with them)."""
        self._inflight.clear()
        self._buffer = []
        self._bcast = None

    # -- checkpoint / resume (checkpoint/checkpoint.py) ------------------------
    # The pending updates ride the archive under the "async" key, their
    # rows stacked (in flight by seq, then the buffer in delivery order),
    # and their dispatch records in the metadata: a restored engine replays
    # the same events without recomputing updates whose broadcasts are
    # gone. The layout is the reference's, so checkpoints cross packages.

    _META_FIELDS = ("delivered_since", "dropped_since", "dispatched_since",
                    "occ_sum", "occ_n", "ver_positions")

    def _row_template(self) -> Dict[str, Any]:
        """The payload keys of this config (the reference's: ``dy``,
        ``dc``, ``c_i``, ``loss``, and ``residual``, ``solver``,
        ``clipped`` where the codec, solver or privatizer keeps them),
        each ``{leaf: (shape, dtype)}`` of one pending row, or ``(shape,
        dtype)`` for the 0-d ones."""
        tr = self.trainer
        scalar = ((), torch.float32)
        tmpl = {"dy": {k: (tuple(v.shape), v.dtype)
                       for k, v in tr.server.x.items()},
                "dc": {k: (tuple(v.shape), v.dtype)
                       for k, v in tr.server.c.items()},
                "c_i": dict(tr.store.template), "loss": scalar}
        if self.up.stateful:
            tmpl["residual"] = dict(tr.residual_store.template)
        if self.solver.stateful:
            tmpl["solver"] = dict(tr.solver_store.template)
        if self.priv.clips:
            tmpl["clipped"] = scalar
        return tmpl

    def _pending_in_order(self) -> Tuple[List[_Pending], List[_Pending]]:
        infl = sorted(self._inflight.values(), key=lambda p: p.dispatch.seq)
        return infl, list(self._buffer)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``(P, ...)`` host rows of every pending update's payload and
        the per-client dispatch counters."""
        infl, buf = self._pending_in_order()
        pend = infl + buf
        tree: Dict[str, Any] = {}
        for key, tmpl in self._row_template().items():
            if isinstance(tmpl, tuple):
                tree[key] = (torch.stack([p.payload(key).cpu() for p in pend])
                             if pend else torch.zeros((0,), dtype=tmpl[1]))
                continue
            tree[key] = {
                leaf: (torch.stack([p.payload(key)[leaf].cpu() for p in pend])
                       if pend else torch.zeros((0,) + shape, dtype=dtype))
                for leaf, (shape, dtype) in tmpl.items()}
        tree["dispatch_k"] = torch.from_numpy(self.sim.dispatch_k.copy())
        return tree

    def checkpoint_meta(self) -> Dict[str, Any]:
        """The JSON event state: every pending update's dispatch record,
        the simulator's scalars and the counters."""
        infl, buf = self._pending_in_order()

        def rec(p: _Pending) -> Dict[str, Any]:
            d = p.dispatch
            return {"seq": d.seq, "client": d.client, "k": d.k,
                    "time": d.time, "latency": d.latency,
                    "dropped": d.dropped, "complete_t": d.complete_t,
                    "version": p.version, "size": p.size}

        meta = {"version": self.version,
                "clock": self.sim.clock,
                "seq": self.sim.seq,
                "dropped_total": self.dropped_total,
                "last_agg_clock": self._last_agg_clock,
                "inflight": [rec(p) for p in infl],
                "buffer": [rec(p) for p in buf]}
        for f in self._META_FIELDS:
            meta[f] = getattr(self, "_" + f)
        return meta

    def pending_template(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """The ``checkpoint_tree``-shaped template (on the meta device)
        for ``meta``'s pending count."""
        p_count = len(meta["inflight"]) + len(meta["buffer"])

        def empty(shape, dtype):
            return torch.empty((p_count,) + tuple(shape), dtype=dtype,
                               device="meta")

        tree: Dict[str, Any] = {}
        for key, tmpl in self._row_template().items():
            tree[key] = (empty(*tmpl) if isinstance(tmpl, tuple) else
                         {leaf: empty(*sd) for leaf, sd in tmpl.items()})
        tree["dispatch_k"] = torch.empty((self.spec.num_clients,),
                                         dtype=torch.int64, device="meta")
        return tree

    def restore(self, tree: Dict[str, Any], meta: Dict[str, Any]) -> None:
        """Rebuild the pending updates and the simulator; the trainer's
        own state (server, stores, RNGs, round counter) is restored by
        ``checkpoint.load_trainer`` around this call."""
        dev = self.trainer.device
        recs = list(meta["inflight"]) + list(meta["buffer"])
        n_inflight = len(meta["inflight"])
        pend = []
        for row, r in enumerate(recs):
            d = Dispatch(int(r["seq"]), int(r["client"]), int(r["k"]),
                         float(r["time"]), float(r["latency"]),
                         bool(r["dropped"]), float(r["complete_t"]))
            fams = {key: _row(tree[key], row)
                    for key in ("c_i", "residual", "solver") if key in tree}
            pend.append(_Pending(
                d, int(r["version"]), float(r["size"]),
                {k: v[row].to(dev) for k, v in tree["dy"].items()},
                {k: v[row].to(dev) for k, v in tree["dc"].items()},
                tree["loss"][row].to(dev),
                tree["clipped"][row].to(dev) if "clipped" in tree else None,
                fams))
        self.version = int(meta["version"])
        self._inflight = {p.dispatch.seq: p for p in pend[:n_inflight]}
        self._buffer = pend[n_inflight:]
        self.dropped_total = int(meta["dropped_total"])
        self._last_agg_clock = float(meta["last_agg_clock"])
        for f in self._META_FIELDS:
            setattr(self, "_" + f, int(meta[f]))
        self._bcast = None
        self.sim.restore(float(meta["clock"]), int(meta["seq"]),
                         tree["dispatch_k"].numpy(),
                         [p.dispatch for p in pend[:n_inflight]])
