"""Host-side federated training controller (the JAX package's
``core/controller.py``): the synchronous host loop and the scanned
engine.

``FederatedTrainer`` owns the ``ServerState`` (x, c and the server
optimizer's slots) on its device, the N-client host stores of control
variates (the paper's stateful clients), of the uplink codec's fp32
error-feedback residuals (a stateful codec only) and, for a stateful
local solver, of its slots, the cohort sampler and the data stream. Each
round samples, gathers, loads, runs ``core.rounds.run_round`` and
scatters, strictly in order — the reference's ``pipeline_depth=0``
loop, with the same host RNG streams (``ClientSampler(seed)``, data from
``np.random.default_rng(seed + 1)``), so both packages draw the same
cohorts and batches. The keyed compression and privacy draws come from
``core.streams`` at the reference's fold paths (``seed + 2`` and
``seed + 3``, keyed by the round index), the LoRA init from
``seed + 4``.

Under an update space that trains a subset (``spec.update_space``,
``core/update_space.py``) the trainer freezes the initial parameters as
``base_params``, ``server.x`` becomes the delta tree, and the grad fn
differentiates in delta space; every store, residual and slot row and
the byte counts then follow the deltas. ``eval_params()`` merges them.

Scanned mode (``scan_rounds=R > 0``, the reference's DESIGN.md §10)
moves the round loop onto the device in chunks of up to R rounds: the
cohorts come from ``DeviceClientSampler`` (stream ``seed``), the data
from the dataset's device protocol (``device_data``,
``device_batch_fn``, stream ``seed + 1``), and the full ``(N, ...)``
client store (c_i, and the residual and slot rows the config carries)
stays on the device (``device_store``), its host stores a mirror that
``sync_host_store`` refreshes for a checkpoint. Every stream is a
function of (seed, absolute round), so any chunking runs the same
rounds bit for bit, and a resume mid-chunk too. A chunk draws its
rounds' randomness up front into fixed device buffers
(``core.streams.DrawAhead``); on the card each round is then one replay
of a CUDA graph of the round, captured once per trainer after one eager
warm-up round on a side stream, over static buffers: the server state
(written back in place at the end of the round), the device store, the
drawn-ahead row and the chunk's metric buffers. The host reads the
metrics once a chunk. A round whose control flow needs the host (the
privatizer's exact clip) runs the same chunks uncaptured
(``scan_graph_reason`` says why); a capture or replay that fails raises.
A dataset without the device protocol falls back to the host loop with
the reference's warning and ``scan_fallback_reason``.
``pipeline_depth`` is ignored while scanning, as the reference ignores
it.

Pipelined mode (``pipeline_depth=d >= 1``, the reference's DESIGN.md §8)
prepares the next d rounds' inputs (sample, gather, weights, batches, in
the host RNG order of the synchronous loop) on a worker thread while the
current round runs, and defers the store scatters and the metrics' host
reads until the round is done. A prepared round whose rows a scatter
overwrote has exactly those rows gathered again (``core.store.
stale_mask`` / ``refresh_rows``), so the trajectory is the synchronous
one bit for bit. ``host_rng_state`` is rewound past the prepared rounds.

``store="tiered"`` (the reference's DESIGN.md §13) keeps the ``(N, ...)``
population in host stores behind ``store_backend`` (``dense``,
``memmap``, ``sharded``) in every mode, with one worker thread for all
their I/O. The scanned engine then holds on the card only a cohort
buffer of ``min(N, scan_rounds * S)`` rows: each chunk's cohorts are
planned from the device cohort stream (the dense engine's cohorts, bit
for bit), the union of their rows is taken from the stores (prefetched
``prefetch_depth`` chunks ahead on the worker), copied through pinned
buffers into the cohort buffer, and written back asynchronously after
the chunk. The captured round reads its global ids and cohort rows at
the draw-ahead slot, as it reads its draws; the worker is drained before
a capture, so no CUDA call from it can meet the capture.

Async mode (``async_buffer=M``, the reference's DESIGN.md §14) hands
the rounds to ``core.async_engine.AsyncBufferedEngine``: up to
``max_inflight`` dispatches in flight against the clients the
availability model says are online, one server step each time M
updates have landed, weighted by their staleness. One round is one
aggregation. It runs over the same stores, sampler and data stream, so
with M = K = S, ``always_on`` and ``constant`` it is this loop bit for
bit. It refuses the scanned and pipelined engines, whole-batch
algorithms and ``client_sequential``, as the reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.api import (
    ClientRoundState,
    get_algorithm,
    init_server_state,
    scan_cohort_round,
    scan_round,
)
from repro_torch.core.async_engine import AsyncBufferedEngine
from repro_torch.core.compression import get_compressor, round_comm_bytes
from repro_torch.core.local_solver import (
    get_local_solver,
    megakernel_incompatibility,
    resolve_local_solver,
)
from repro_torch.core.privatizer import get_privatizer
from repro_torch.core.rounds import run_round
from repro_torch.core.sampling import (
    ClientSampler,
    DeviceClientSampler,
    device_sample_ids,
)
from repro_torch.core.store import (
    ClientStateStore,
    TieredClientStore,
    make_store_backend,
    refresh_rows,
    stale_mask,
)
from repro_torch.core.streams import (
    DrawAhead,
    base_from_state,
    key_state,
    round_key,
    stream_key,
)
from repro_torch.core.tree import tree_flatten_slots
from repro_torch.core.update_space import (
    get_update_space,
    resolve_update_space,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import counts

# bytes of drawn-ahead randomness a scanned trainer holds on the device:
# a chunk whose rounds draw more (noise on a large model) is drawn and
# run in pieces of fewer rounds
DRAW_AHEAD_BYTES = 1 << 30


def _leaves(tree):
    """The tensors of nested dicts of tensors, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _state_tree(server):
    """A ``ServerState``'s tensors as nested dicts."""
    return {"x": server.x, "c": server.c, "opt_state": server.opt_state}


def _copy_into(dst, src) -> None:
    """Copy nested dicts of tensors ``src`` into the like-structured
    ``dst`` in place (a tensor that is ``dst``'s own is left as it is)."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        elif src[k] is not v:
            v.copy_(src[k])


def make_grad_fn(loss_fn: Callable, *, space=None, spec=None,
                 base_params=None) -> Callable:
    """``loss_fn(params, batch) -> (scalar, metrics)``  =>
    ``grad_fn(params, batch) -> (grads, metrics)`` by autograd.

    The gradient is taken at detached copies of the leaves, so ``params``
    (a client's working copy) can be updated in place afterwards. The
    loss's ``megakernel_grad`` marker is propagated, so
    ``megakernel_incompatibility`` gates on the grad fn it receives.

    With a ``space`` that trains a subset, ``grad_fn(deltas, batch)``
    evaluates the loss at ``space.apply(spec, base_params, deltas)``,
    differentiates only the leaves of ``space.grad_keys`` and pulls them
    back through ``space.grad_project``: the exact chain rule. The
    megakernel marker is dropped there (the delta-space gradient is not
    the loss's closed form)."""

    if space is not None and space.trains_subset:

        def subset_grad_fn(deltas, batch):
            with torch.no_grad():
                full = space.apply(spec, base_params, deltas)
            keys = space.grad_keys(spec, base_params, deltas)
            with torch.enable_grad():
                leaves = {k: full[k].detach().requires_grad_(True)
                          for k in keys}
                loss, metrics = loss_fn({**full, **leaves}, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            del full
            with torch.no_grad():
                out = space.grad_project(spec, base_params, deltas,
                                         dict(zip(keys, grads)))
            return out, {k: v.detach() for k, v in metrics.items()}

        subset_grad_fn.megakernel_grad = None
        return subset_grad_fn

    def grad_fn(params, batch):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, metrics = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in metrics.items()})

    grad_fn.megakernel_grad = getattr(loss_fn, "megakernel_grad", None)
    return grad_fn


class _ChunkPlan(NamedTuple):
    """The cohort plan of one tiered scanned chunk: its rounds' global
    cohort ids, their union (the population rows the chunk needs, at most
    the cohort buffer's min(N, scan_rounds * S)), and the same cohorts as
    rows of the cohort buffer."""

    round_ids: np.ndarray  # (R, S) int64, global ids
    union: np.ndarray      # (u,) sorted unique global ids
    slot_ids: np.ndarray   # (R, S) int64, rows of the cohort buffer


class _RoundInputs(NamedTuple):
    """One round's inputs, prepared on the host: the sampled ids, their
    gathered c_i, residual and slot rows (owned host tensors, repaired in
    place when a scatter overwrites them), the weights, the batches, and
    the host RNG states from before they were prepared (what a checkpoint
    records to prepare them again)."""

    ids: np.ndarray
    c_i: Any
    uplink_res: Any
    solver_slots: Any
    weights: Optional[torch.Tensor]
    batches: Any
    host_state: Dict[str, Any]


class FederatedTrainer:
    """Runs the ported federated algorithms against a federated dataset
    whose ``round_batches(ids, K, b, rng, device=...)`` returns a dict
    with leaves (S, K, b, ...).

    ``init_params(generator)`` builds the initial model from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (a callable
    that ignores it, e.g. one returning converted JAX weights, is fine);
    the leaves are moved to ``device``. ``device`` defaults to the card
    and raises where there is none.

    ``pipeline_depth=d >= 1`` prepares up to d rounds' inputs ahead while
    a round runs; trajectories are the synchronous loop's.
    ``scan_rounds=R > 0`` runs the scanned engine in chunks of up to R
    rounds (the dataset's ``device_data(device=)``,
    ``device_batch_fn(K, b)`` and, weighted, ``device_client_sizes
    (device=)``); a dataset without them falls back to the host loop and
    says why in ``scan_fallback_reason``.

    ``store="tiered"`` keeps the population host-side behind
    ``store_backend`` in every mode, with ``prefetch_depth`` chunks of
    gather-ahead; the scanned engine then holds only the cohort buffer of
    min(N, R * S) rows on the device. Trajectories are the dense store's
    bit for bit.

    ``async_buffer=M > 0`` runs the async buffered engine (one round an
    aggregation of M updates) with up to ``max_inflight`` dispatches in
    flight (0: ``num_sampled``), clients online and late as the
    ``availability`` model says (a registered name with
    ``availability_kwargs``, or an ``AvailabilityModel``), updates
    weighted by ``staleness_weighting`` (a name with ``staleness_kwargs``,
    or a ``StalenessWeighting``).
    """

    def __init__(self, loss_fn, init_params, spec, dataset, *, seed: int = 0,
                 use_fused_update: bool = False, device="cuda",
                 pipeline_depth: int = 0, scan_rounds: int = 0,
                 store: str = "dense", store_backend: str = "",
                 prefetch_depth: int = 2, async_buffer: int = 0,
                 max_inflight: int = 0, availability: Any = "always_on",
                 availability_kwargs: Optional[Dict[str, Any]] = None,
                 staleness_weighting: Any = "constant",
                 staleness_kwargs: Optional[Dict[str, Any]] = None):
        assert pipeline_depth >= 0, pipeline_depth
        assert scan_rounds >= 0, scan_rounds
        assert store in ("dense", "tiered"), store
        assert prefetch_depth >= 1, prefetch_depth
        assert async_buffer >= 0, async_buffer
        if async_buffer and scan_rounds:
            raise ValueError(
                "async_buffer is incompatible with scan_rounds: the scanned "
                "engine is a synchronous-cohort loop by construction")
        if async_buffer and pipeline_depth:
            raise ValueError(
                "async_buffer is incompatible with pipeline_depth: the async "
                "engine owns its own dispatch overlap")
        self.device = resolve_device(device)
        self.spec = spec
        self.dataset = dataset
        self.scan_rounds = int(scan_rounds)
        self.scan_fallback_reason: Optional[str] = None
        if self.scan_rounds > 0:
            self.scan_fallback_reason = self._scan_incompatibility()
            if self.scan_fallback_reason is not None:
                warnings.warn(
                    f"scan_rounds={scan_rounds} requested but running the "
                    f"host loop: {self.scan_fallback_reason}", stacklevel=2)
        self._scan_mode = (self.scan_rounds > 0
                           and self.scan_fallback_reason is None)
        self.pipeline_depth = int(pipeline_depth)
        self.algorithm = get_algorithm(spec.algorithm)
        if spec.weighted_aggregation and not hasattr(dataset, "client_sizes"):
            raise ValueError(
                "spec.weighted_aggregation=True needs the dataset to expose "
                "client_sizes(ids); add it or disable weighting")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = {k: v.to(self.device) for k, v in init_params(gen).items()}
        # a space that trains a subset freezes the initial parameters and
        # trains its delta tree, drawn from the fifth keyed stream
        self.update_space = get_update_space(resolve_update_space(spec))
        self.base_params = None
        if self.update_space.trains_subset:
            self.base_params = x
            x = self.update_space.init_deltas(
                spec, x, stream_key(seed + 4, self.device))
        self.server = init_server_state(spec, x)
        # the population stores: dense, or tiered behind one worker thread
        # for every row family, so gather-ahead repairs stay ordered
        self.store_kind = store
        self.prefetch_depth = int(prefetch_depth)
        self._store_exec: Optional[ThreadPoolExecutor] = None
        if store == "tiered":
            self._store_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tiered-store")

        def make_store(template):
            if store == "tiered":
                return TieredClientStore(
                    template, spec.num_clients,
                    backend=make_store_backend(store_backend or "dense"),
                    prefetch_depth=self.prefetch_depth,
                    executor=self._store_exec)
            return ClientStateStore(template, spec.num_clients,
                                    backend=store_backend or "dense")

        # templates on the meta device: the stores read only their shapes
        # and dtypes
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in self.server.x.items()}
        self.store = make_store(meta)
        # the uplink codec's fp32 error-feedback residuals persist per
        # client across rounds (a stateful codec only)
        self.compressor = get_compressor(spec.compress)
        self.residual_store = None
        if self.compressor.stateful:
            self.residual_store = make_store(
                {k: v.float() for k, v in meta.items()})
        self.local_solver = get_local_solver(resolve_local_solver(spec))
        # a stateful local solver's slots persist per client across
        # rounds: one more row family, zeros for clients never sampled
        self.solver_store = None
        if self.local_solver.stateful:
            self.solver_store = make_store(
                tree_flatten_slots(self.local_solver.init(spec, meta)))
        self.sampler = ClientSampler(spec.num_clients, spec.num_sampled, seed)
        self._rng = np.random.default_rng(seed + 1)
        # the keyed streams, stateless in the round index: compression
        # (only keyed codecs draw) and privacy (only noise draws)
        self._comp_seed, self._priv_seed = seed + 2, seed + 3
        self._comm_bytes = {
            k: float(v) for k, v in round_comm_bytes(
                spec, self.server.x,
                stateful_clients=self.algorithm.stateful_clients).items()}
        self._grad_fn = grad_fn = make_grad_fn(
            loss_fn, space=self.update_space, spec=spec,
            base_params=self.base_params)
        self._use_fused_update = use_fused_update
        # megakernel capability gate, decided once from static config: ""
        # when every local loop takes the K-step kernel, a reason string
        # when it falls back to the per-step path, None when not asked
        self.megakernel_fallback_reason: Optional[str] = None
        if spec.use_megakernel:
            if self.algorithm.whole_batch:
                self.megakernel_fallback_reason = (
                    f"whole-batch {spec.algorithm!r} runs no local steps")
            else:
                self.megakernel_fallback_reason = megakernel_incompatibility(
                    grad_fn, self.local_solver,
                    prox_mu=self.algorithm.prox_mu(spec),
                    params=self.server.x) or ""
            if self.megakernel_fallback_reason:
                warnings.warn(
                    f"use_megakernel requested but running the per-step "
                    f"path: {self.megakernel_fallback_reason}", stacklevel=2)
        self.round_idx = 0
        self.history = []
        # the pipelined host loop: futures of prepared rounds, in order,
        # from one worker (so the host RNG streams advance as in the
        # synchronous loop)
        self._prefetch: deque = deque()
        self._prep_exec: Optional[ThreadPoolExecutor] = None
        self._tiered_scan = False
        if self._scan_mode:
            self._setup_scan(seed)
        self.async_engine: Optional[AsyncBufferedEngine] = None
        if async_buffer:
            self.async_engine = AsyncBufferedEngine(
                self, buffer_size=async_buffer, max_inflight=max_inflight,
                availability=availability,
                availability_kwargs=availability_kwargs,
                staleness_weighting=staleness_weighting,
                staleness_kwargs=staleness_kwargs)

    def _scan_incompatibility(self) -> Optional[str]:
        """Why this config can't run the scanned engine (None = it can);
        the reference's reasons, word for word."""
        d = self.dataset
        if not (hasattr(d, "device_data") and hasattr(d, "device_batch_fn")):
            return (f"dataset {type(d).__name__} has no device-data protocol "
                    f"(device_data()/device_batch_fn(K, b))")
        if (self.spec.weighted_aggregation
                and not hasattr(d, "device_client_sizes")):
            return ("weighted_aggregation needs "
                    f"{type(d).__name__}.device_client_sizes()")
        return None

    @property
    def scan_active(self) -> bool:
        """True when rounds run through the scanned engine."""
        return self._scan_mode

    @property
    def async_active(self) -> bool:
        """True when rounds run through the async buffered engine."""
        return self.async_engine is not None

    # -- views of the server state ----------------------------------------

    @property
    def x(self):
        return self.server.x

    @x.setter
    def x(self, value):
        self.server = dataclasses.replace(self.server, x=value)

    @property
    def c(self):
        return self.server.c

    @c.setter
    def c(self, value):
        self.server = dataclasses.replace(self.server, c=value)

    def eval_params(self):
        """The full parameter dict for evaluation: ``server.x`` in the
        ``full`` space (the same tensors), else the frozen base with the
        trained deltas merged in (``update_space.apply``)."""
        if self.base_params is None:
            return self.server.x
        with torch.no_grad():
            return self.update_space.apply(self.spec, self.base_params,
                                           self.server.x)

    # -- the host RNG state a checkpoint carries ---------------------------

    def _rng_state_now(self) -> Dict[str, Any]:
        return {"sampler": self.sampler.get_state(),
                "data_rng": self._rng.bit_generator.state,
                "comp_key": key_state(self._comp_seed),
                "priv_key": key_state(self._priv_seed)}

    def host_rng_state(self) -> Dict[str, Any]:
        """The sampler's and the data stream's numpy states as of the next
        round not yet prepared (rewound past the pipeline's prepared
        rounds, so a restore prepares them again), and the keyed streams'
        root keys (stateless in the round index, so their seeds are all
        they need), under the reference's keys; in scanned mode also the
        device cohort and data streams' root keys."""
        if self._prefetch:
            return self._prefetch[0].result().host_state
        state = self._rng_state_now()
        if self._scan_mode:
            state["device_sampler"] = self.device_sampler.get_state()
            state["device_data_key"] = key_state(self._data_seed)
        return state

    def set_host_rng_state(self, state: Dict[str, Any]) -> None:
        self._drop_pipeline()
        if self._tiered_scan:
            self._drop_tiered_prefetch()
        self.sampler.set_state(state["sampler"])
        self._rng.bit_generator.state = state["data_rng"]
        if "comp_key" in state:
            self._comp_seed = base_from_state(state["comp_key"])
        if "priv_key" in state:
            self._priv_seed = base_from_state(state["priv_key"])
        if self._scan_mode:
            if "device_sampler" in state:
                self.device_sampler.set_state(state["device_sampler"])
                self._data_seed = base_from_state(state["device_data_key"])
            # the recorded draws are keyed by the old seeds
            self._reset_scan()

    # -- the client stores ---------------------------------------------------

    def _store_families(self):
        """The per-client row families as (name, host store) pairs, named
        as the scanned engine's store dict keys them."""
        fams = [("c_i", self.store)]
        if self.residual_store is not None:
            fams.append(("residual", self.residual_store))
        if self.solver_store is not None:
            fams.append(("solver", self.solver_store))
        return fams

    def _device_families(self):
        """The device store (the cohort buffer, tiered) as ``{family:
        rows}``."""
        if len(self._store_families()) > 1:
            return self.device_store
        return {"c_i": self.device_store}

    def client_store_device_bytes(self,
                                  chunk_rounds: Optional[int] = None) -> int:
        """Peak device-resident client-store bytes of this trainer's mode:
        the full ``(N, ...)`` store under the dense scanned engine; the
        cohort buffer's ``min(N, R * S)`` rows under the tiered one
        (``chunk_rounds`` overrides ``scan_rounds``); one gathered cohort
        a round in flight under the host loop (pipelined: depth + 1); the
        reference's reckoning of the pending payloads under the async
        engine, ``(max_inflight + buffer_size)`` rows."""
        row = sum(st.row_nbytes for _, st in self._store_families())
        N, S = self.spec.num_clients, self.spec.num_sampled
        if self.async_engine is not None:
            eng = self.async_engine
            return (eng.max_inflight + eng.buffer_size) * row
        if self._tiered_scan:
            return min(N, (chunk_rounds or self.scan_rounds) * S) * row
        if self._scan_mode:
            return N * row
        return S * row * (self.pipeline_depth + 1)

    def sync_host_store(self) -> None:
        """Make the host stores hold every client's rows (a checkpoint
        reads those): mirror the dense scanned engine's device store into
        them, or, tiered, wait for the queued write-backs."""
        if self.store_kind == "tiered":
            for _, st in self._store_families():
                st.flush()
        if self._scan_mode and not self._tiered_scan \
                and self._host_store_dirty:
            all_ids = np.arange(self.spec.num_clients)
            rows = self._device_families()
            for name, st in self._store_families():
                st.scatter(all_ids, rows[name])
            self._host_store_dirty = False

    def push_host_store_to_device(self) -> None:
        """After a checkpoint restore scattered into the host stores:
        reload the dense scanned engine's device store, in place (a
        captured round keeps reading the same buffers); under the tiered
        one forget the gather-ahead, which read the old rows."""
        if self._tiered_scan:
            self._drop_tiered_prefetch()
        elif self._scan_mode:
            rows = self._device_families()
            for name, st in self._store_families():
                for k, v in st.all_rows().items():
                    rows[name][k].copy_(v)
            self._host_store_dirty = False

    # -- the host loop: synchronous and pipelined --------------------------

    def _prepare_inputs(self) -> _RoundInputs:
        """Sample, gather, weights, load: in the synchronous loop's host
        RNG order (the pipeline moves the calls earlier in time and never
        reorders them across rounds)."""
        host_state = self._rng_state_now()
        ids = self.sampler.sample()
        c_i = self.store.gather(ids)
        res = (None if self.residual_store is None
               else self.residual_store.gather(ids))
        slots = (None if self.solver_store is None
                 else self.solver_store.gather(ids))
        weights = None
        if self.spec.weighted_aggregation:
            weights = torch.as_tensor(
                np.asarray(self.dataset.client_sizes(ids), np.float32))
        batches = self.dataset.round_batches(
            ids, self.spec.local_steps, self.spec.local_batch, self._rng,
            device=self.device)
        return _RoundInputs(ids, c_i, res, slots, weights, batches,
                            host_state)

    def _refresh_stale_rows(self, inp: _RoundInputs,
                            ids_written: np.ndarray) -> None:
        """Gather again the rows of a prepared round that a scatter just
        overwrote: gather-when-run semantics for the pipeline."""
        stale = stale_mask(inp.ids, ids_written)
        if not stale.any():
            return
        stale_ids = inp.ids[stale]
        for rows, st in ((inp.c_i, self.store),
                         (inp.uplink_res, self.residual_store),
                         (inp.solver_slots, self.solver_store)):
            if rows is not None and st is not None:
                refresh_rows(rows, st.gather(stale_ids), stale)

    def _fill_pipeline(self) -> None:
        """Queue the preparation of rounds until ``pipeline_depth`` are
        prepared or in preparation."""
        if self._prep_exec is None:
            self._prep_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="round-prepare")
        while len(self._prefetch) < self.pipeline_depth:
            self._prefetch.append(self._prep_exec.submit(
                self._prepare_inputs))

    def _drop_pipeline(self) -> None:
        """Forget the prepared rounds, after every preparation in flight
        has finished (it advances the host RNG streams)."""
        pending, self._prefetch = self._prefetch, deque()
        for fut in pending:
            fut.exception()

    def _record(self, m: Dict[str, Any]) -> Dict[str, Any]:
        """Finish a round's metrics on the host (exact byte counts, the
        float64 accountant, the reasons), advance the round counter, and
        append them to ``history``."""
        self.round_idx += 1
        m.update(self._comm_bytes)
        if self.spec.privatizer != "none":
            m["dp_epsilon"] = get_privatizer(self.spec.privatizer).epsilon(
                self.spec, self.round_idx)
        if self.megakernel_fallback_reason is not None:
            m["megakernel_fallback_reason"] = self.megakernel_fallback_reason
        if self.update_space.trains_subset:
            m["update_space"] = self.update_space.name
        m["round"] = self.round_idx
        self.history.append(m)
        return m

    def run_round(self) -> Dict[str, Any]:
        """Sample, gather, load, run one round, scatter; returns the
        round's metrics (also appended to ``history``). Pipelined, the
        next rounds are prepared while this one runs. In scanned mode, a
        chunk of one round: the same bits as any larger chunk. In async
        mode, one buffered aggregation."""
        if self.async_engine is not None:
            return self.async_engine.run_round()
        if self._scan_mode:
            return self._run_scan_chunk(1)[0]
        inp = (self._prefetch.popleft().result() if self._prefetch
               else self._prepare_inputs())
        if self.pipeline_depth:
            self._fill_pipeline()
        t = self.round_idx
        out = run_round(self._grad_fn, self.spec, self.server,
                        ClientRoundState(c_i=inp.c_i,
                                         uplink_residual=inp.uplink_res,
                                         weights=inp.weights,
                                         solver_slots=inp.solver_slots),
                        inp.batches,
                        use_fused_update=self._use_fused_update,
                        comp_key=round_key(self._comp_seed, t, self.device),
                        priv_key=round_key(self._priv_seed, t, self.device),
                        dp_round=t)
        ids = inp.ids
        del inp
        self.server = out.server
        # the prepared rounds gathered before this round's scatter: wait
        # for them, then repair what the scatter overwrites
        pending = [fut.result() for fut in self._prefetch]
        scattered = False
        if self.algorithm.stateful_clients:
            self.store.scatter(ids, out.clients.c_i)
            scattered = True
        if self.residual_store is not None:
            self.residual_store.scatter(ids, out.clients.uplink_residual)
            scattered = True
        if self.solver_store is not None:
            self.solver_store.scatter(ids, out.clients.solver_slots)
            scattered = True
        if scattered:
            for prepared in pending:
                self._refresh_stale_rows(prepared, ids)
        return self._record({k: float(v) for k, v in out.metrics.items()})

    def run(self, rounds: int, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 0, target_metric: Optional[float] = None,
            metric_name: str = "accuracy", verbose: bool = False):
        """Run rounds; with ``target_metric``, stop once
        ``eval_fn(x)[metric_name] >= target`` and return the rounds used.

        In scanned mode the rounds run in chunks of up to
        ``scan_rounds``, the chunk ends aligned to ``eval_every`` so the
        eval and early-stop schedule is the host loop's."""
        done = 0
        while done < rounds:
            chunk = 1
            if self._scan_mode:
                chunk = min(self.scan_rounds, rounds - done)
                if eval_fn is not None and eval_every:
                    chunk = min(chunk, eval_every - done % eval_every)
                m = self._run_scan_chunk(chunk)[-1]
            else:
                m = self.run_round()
            done += chunk
            if eval_fn is not None and eval_every and done % eval_every == 0:
                em = eval_fn(self.eval_params())
                m.update(em)
                if verbose:
                    print(f"round {done}: {m}")
                if (target_metric is not None
                        and em[metric_name] >= target_metric):
                    return done
        return rounds

    # -- the scanned engine ---------------------------------------------------

    def _setup_scan(self, seed: int) -> None:
        dev, spec = self.device, self.spec
        self.device_sampler = DeviceClientSampler(
            spec.num_clients, spec.num_sampled, seed, device=dev)
        self._data_seed = seed + 1
        self._device_data = self.dataset.device_data(device=dev)
        self._device_batch_fn = self.dataset.device_batch_fn(
            spec.local_steps, spec.local_batch)
        self._tiered_scan = self.store_kind == "tiered"
        # the device store: every client's rows, or (tiered) the cohort
        # buffer of min(N, R * S) rows
        n_rows = spec.num_clients
        if self._tiered_scan:
            n_rows = min(spec.num_clients, self.scan_rounds * spec.num_sampled)
        rows = {name: {k: torch.zeros((n_rows,) + shape, dtype=dtype,
                                      device=dev)
                       for k, (shape, dtype) in st.template.items()}
                for name, st in self._store_families()}
        self.device_store = rows if len(rows) > 1 else rows["c_i"]
        self._host_store_dirty = False
        self._device_sizes = None
        if self._tiered_scan:
            self._setup_tiered_scan()
        elif spec.weighted_aggregation:
            self._device_sizes = self.dataset.device_client_sizes(device=dev)
        priv = get_privatizer(spec.privatizer)
        # whether a round is captured as a CUDA graph is decided here, from
        # the static config, as megakernel_fallback_reason is
        self.scan_graph_reason: Optional[str] = None
        if dev.type != "cuda":
            self.scan_graph_reason = f"device {dev}: CUDA graphs need the card"
        elif priv.clips:
            self.scan_graph_reason = (
                f"privatizer {priv.name!r}: its exact clip reads the norm on "
                f"the host")
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._reset_scan()

    def _reset_scan(self) -> None:
        """Forget the recorded draws, the metric buffers and the graph:
        the next round records, warms up and captures again."""
        self._ahead = DrawAhead(self.scan_rounds, self.device)
        self._metrics_buf: Optional[Dict[str, torch.Tensor]] = None
        self._graph = self._tally = self._captured = None
        self._warm = False

    @property
    def scan_captured(self) -> bool:
        """True when scanned rounds run as replays of a CUDA graph."""
        return self._scan_mode and self.scan_graph_reason is None

    def _scan_step(self, t: int) -> None:
        """The scanned round ``t`` over the static buffers: the server
        state (written back in place), the device store, the drawn-ahead
        row at the slot (and, tiered, the cohort's ids and weights at the
        slot); its tensor metrics go into the chunk's buffers at the slot,
        which it then advances. What a graph captures."""
        dev, ahead = self.device, self._ahead
        keys = dict(data_key=stream_key(self._data_seed, dev),
                    comp_key=stream_key(self._comp_seed, dev),
                    priv_key=stream_key(self._priv_seed, dev),
                    use_fused_update=self._use_fused_update)
        with ahead.serving(t):
            if self._tiered_scan:
                slot = ahead.slot
                out = scan_cohort_round(
                    self._grad_fn, self.spec, self.server, self.device_store,
                    t, data=self._device_data, batch_fn=self._device_batch_fn,
                    round_ids=self._cohort_ids.index_select(0, slot)[0],
                    slot_ids=self._cohort_slots.index_select(0, slot)[0],
                    weights=(None if self._cohort_weights is None else
                             self._cohort_weights.index_select(0, slot)[0]),
                    **keys)
            else:
                out = scan_round(
                    self._grad_fn, self.spec, self.server, self.device_store,
                    t, data=self._device_data, batch_fn=self._device_batch_fn,
                    sample_key=self.device_sampler.key,
                    sizes=self._device_sizes, **keys)
        _copy_into(_state_tree(self.server), _state_tree(out.server))
        metrics = {k: v for k, v in out.metrics.items()
                   if isinstance(v, torch.Tensor)}
        if self._metrics_buf is None:
            self._metrics_buf = {
                k: torch.zeros(self.scan_rounds, dtype=torch.float32,
                               device=dev) for k in metrics}
        for k, buf in self._metrics_buf.items():
            buf.index_copy_(0, ahead.slot, metrics[k].reshape(1).float())
        ahead.slot.add_(1)

    def _static_buffers(self):
        """The tensors a captured round reads and writes in place."""
        return _leaves({**_state_tree(self.server),
                        "store": self._device_families()})

    def _run_step(self, t: int) -> None:
        """One scanned round: eager off the card or when its control flow
        needs the host; else a warm-up round on a side stream, then the
        round captured once as a CUDA graph, then its replays."""
        if self.scan_graph_reason is not None:
            self._scan_step(t)
            return
        if self._graph is None and not self._warm:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                self._scan_step(t)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self._warm = True
            return
        if self._graph is None:
            if self._tiered_scan:
                # the store worker makes CUDA calls (a plan's draws, the
                # wait on a write-back's copy): none may meet the capture
                self._store_exec.submit(int).result()
            graph = torch.cuda.CUDAGraph()
            with counts.recording() as tally, torch.cuda.graph(
                    graph, stream=self._stream):
                self._scan_step(t)
            self._graph, self._tally = graph, tally
            self._captured = self._static_buffers()
        self._graph.replay()
        self._tally.replayed()

    def _check_static(self) -> None:
        """Drop the graph when a buffer it captured was replaced (a
        checkpoint restore or a setter swaps the server state's tensors):
        the next round warms up and captures again."""
        if self._graph is None:
            return
        now = self._static_buffers()
        if len(now) != len(self._captured) or any(
                a is not b for a, b in zip(now, self._captured)):
            self._graph = self._tally = self._captured = None
            self._warm = False

    def _run_scan_chunk(self, R: int):
        """R rounds through the scanned engine; returns their metric dicts
        (also appended to ``history``). The first round a trainer runs
        records its draws; later rounds are drawn ahead a piece of up to
        the buffers' capacity at a time. Tiered, each piece takes its
        cohort rows in before its rounds and writes them back after."""
        self._check_static()
        ahead, out, done = self._ahead, [], 0
        while done < R:
            t0 = self.round_idx
            n = min(R - done, ahead.capacity) if ahead.recorded else 1
            plan = self._load_cohort(t0, n) if self._tiered_scan else None
            if ahead.recorded:
                ahead.fill(t0, n)
            ahead.slot.zero_()
            for r in range(n):
                self._run_step(t0 + r)
            if not ahead.bufs:
                per_round = max(1, ahead.round_bytes())
                ahead.allocate(max(1, min(self.scan_rounds,
                                          DRAW_AHEAD_BYTES // per_round)))
            if plan is not None:
                # the next pieces' plans and reads run on the worker while
                # the card computes this one
                left = R - done - n
                self._queue_prefetch(t0 + n, min(
                    left if left else self.scan_rounds, ahead.capacity))
                self._write_back(plan)
            names = list(self._metrics_buf)
            vals = torch.stack([self._metrics_buf[k][:n]
                                for k in names]).cpu().tolist()
            for r in range(n):
                m = {k: vals[i][r] for i, k in enumerate(names)}
                out.append(self._record(m))
            done += n
        self._host_store_dirty = True
        return out

    # -- the tiered scanned engine ---------------------------------------------

    def _setup_tiered_scan(self) -> None:
        """The tiered engine's static buffers: the chunk's global ids and
        cohort slots (and weights) a round, on the device; on the card
        pinned host buffers for the cohort rows' copies, made here, before
        any capture."""
        dev, spec = self.device, self.spec
        shape = (self.scan_rounds, spec.num_sampled)
        self._cohort_ids = torch.zeros(shape, dtype=torch.int64, device=dev)
        self._cohort_slots = torch.zeros(shape, dtype=torch.int64, device=dev)
        self._cohort_weights = None
        self._sizes_host = None
        if spec.weighted_aggregation:
            self._cohort_weights = torch.zeros(shape, dtype=torch.float32,
                                               device=dev)
            self._sizes_host = self.dataset.device_client_sizes(
                device="cpu").float()
        self._plan_futures: "OrderedDict[tuple, Any]" = OrderedDict()
        self._stage_in = self._stage_out = None
        self._plan_stream = self._h2d_done = None
        self._writes_pending: list = []
        if dev.type == "cuda":
            pinned = lambda: {  # noqa: E731
                name: {k: torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                       for k, v in rows.items()}
                for name, rows in self._device_families().items()}
            self._stage_in, self._stage_out = pinned(), pinned()
            self._plan_stream = torch.cuda.Stream(dev)
            self._h2d_done = torch.cuda.Event()

    def _plan_chunk(self, t0: int, R: int) -> _ChunkPlan:
        """The cohorts of rounds ``t0 .. t0 + R - 1``, drawn from the
        dense engine's stream (``device_sample_ids`` on the trainer's
        device: the same permutations), their union, and their rows in
        the cohort buffer."""
        key, N, S = (self.device_sampler.key, self.spec.num_clients,
                     self.spec.num_sampled)
        on = (torch.cuda.stream(self._plan_stream)
              if self._plan_stream is not None else contextlib.nullcontext())
        with on:
            ids = torch.stack([device_sample_ids(key, t, N, S)
                               for t in range(t0, t0 + R)])
            round_ids = ids.cpu().numpy()
        union, inv = np.unique(round_ids, return_inverse=True)
        return _ChunkPlan(round_ids=round_ids, union=union.astype(np.int64),
                          slot_ids=inv.reshape(round_ids.shape).astype(
                              np.int64))

    def _plan_and_prefetch(self, t0: int, R: int) -> _ChunkPlan:
        """On the store worker: plan the chunk, then queue the reads of its
        union's rows under the token (t0, R); they run next on the same
        worker, while the card computes."""
        plan = self._plan_chunk(t0, R)
        for _, st in self._store_families():
            st.prefetch((t0, R), plan.union)
        return plan

    def _queue_prefetch(self, t0: int, R: int) -> None:
        """Gather-ahead: queue the plans and reads of the next
        ``prefetch_depth`` chunks of R rounds from ``t0`` (a chunk that
        starts elsewhere plans and gathers when it runs)."""
        for i in range(self.prefetch_depth):
            token = (t0 + i * R, R)
            if token not in self._plan_futures:
                self._plan_futures[token] = self._store_exec.submit(
                    self._plan_and_prefetch, *token)
        while len(self._plan_futures) > self.prefetch_depth:
            self._plan_futures.popitem(last=False)  # plans are read-only

    def _drop_tiered_prefetch(self) -> None:
        """Forget the gather-ahead (a checkpoint restore: the cohort
        stream restarts from the restored round), after the plans in
        flight have finished, so that no read they queue lands later."""
        plans, self._plan_futures = self._plan_futures, OrderedDict()
        for fut in plans.values():
            fut.result()
        for _, st in self._store_families():
            st.drop_prefetches()

    def _load_cohort(self, t0: int, n: int) -> _ChunkPlan:
        """Take the piece's plan and its union's rows (prefetched, or
        gathered now), copy the rows into the first u rows of the cohort
        buffer (on the card through pinned buffers, asynchronously) and
        the rounds' ids, slots and weights into their buffers."""
        token = (t0, n)
        fut = self._plan_futures.pop(token, None)
        plan = fut.result() if fut is not None else self._plan_chunk(t0, n)
        u = len(plan.union)
        rows = self._device_families()
        if self._h2d_done is not None:
            # the pinned buffers are free once the last piece's copies landed
            self._h2d_done.synchronize()
        for name, st in self._store_families():
            got = st.take(token, plan.union)
            for k, buf in rows[name].items():
                if self._stage_in is None:
                    buf[:u].copy_(got[k])
                else:
                    stage = self._stage_in[name][k][:u]
                    stage.copy_(got[k])
                    buf[:u].copy_(stage, non_blocking=True)
        self._cohort_ids[:n].copy_(torch.from_numpy(plan.round_ids))
        self._cohort_slots[:n].copy_(torch.from_numpy(plan.slot_ids))
        if self._cohort_weights is not None:
            self._cohort_weights[:n].copy_(
                self._sizes_host[torch.from_numpy(plan.round_ids)])
        if self._h2d_done is not None:
            self._h2d_done.record()
        return plan

    def _write_back(self, plan: _ChunkPlan) -> None:
        """Queue the write of the union's rows back to the population: on
        the card copied into pinned buffers after the piece's rounds, the
        worker waiting on the copies' event before it writes."""
        u = len(plan.union)
        rows = self._device_families()
        if self._stage_out is None:
            for name, st in self._store_families():
                st.scatter_async(plan.union, {k: v[:u].clone()
                                              for k, v in rows[name].items()})
            return
        for fut in self._writes_pending:
            fut.result()  # the pinned buffers are free again
        out = {name: {k: self._stage_out[name][k][:u] for k in fam}
               for name, fam in rows.items()}
        for name, fam in rows.items():
            for k, v in fam.items():
                out[name][k].copy_(v[:u], non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        self._writes_pending = [
            st.scatter_async(plan.union, out[name], ready=ready)
            for name, st in self._store_families()]

    def close(self) -> None:
        """Release the stores (the tiered store's worker, memmap files),
        the pipeline's worker, a captured round's graph and the async
        engine's pending updates."""
        if self.async_engine is not None:
            self.async_engine.close()
        if self._scan_mode:
            self._graph = self._tally = self._captured = None
            if self._tiered_scan:
                self._drop_tiered_prefetch()
        self._drop_pipeline()
        if self._prep_exec is not None:
            self._prep_exec.shutdown(wait=True)
            self._prep_exec = None
        for _, st in self._store_families():
            st.close()
        if self._store_exec is not None:
            self._store_exec.shutdown(wait=True)
            self._store_exec = None
