"""Typed round state and the algorithm / server-optimizer registries
(the JAX package's ``core/api.py``).

  ServerState       the server's model ``x``, control variate ``c`` and
                    server-optimizer slots.
  ClientRoundState  the S sampled clients' round state: control variates
                    ``c_i``, the uplink codec's error-feedback residuals
                    and the stateful local solvers' slot rows (leaves
                    ``(S, ...)``, host tensors — the engine moves one
                    client's rows to the device at a time), plus optional
                    aggregation weights.
  RoundOutput       new server state, new client state and the metrics.

Registered algorithms: ``scaffold`` (options I and II), ``scaffold_m``,
``fedavg``, ``fedavgm``, ``fedprox`` and the large-batch ``sgd``
baseline; server optimizers: ``sgd``, ``momentum`` and ``adam``.

``run_rounds`` is the scanned engine's round loop over a device-resident
``(N, ...)`` client store (the reference's ``lax.scan``), and
``scan_round`` its body, one round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_map, tree_sub, tree_zeros_like

# ---------------------------------------------------------------------------
# typed round state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServerState:
    """x: model parameters; c: server control variate (zeros and unused
    for non-SCAFFOLD algorithms); opt_state: server-optimizer slots."""

    x: Any
    c: Any
    opt_state: Any


@dataclasses.dataclass
class ClientRoundState:
    """Round-scoped state of the S sampled clients.

    c_i:          control variates, leaves ``(S, ...)``.
    uplink_residual: the stateful uplink codec's fp32 error-feedback
                  residuals, leaves ``(S, ...)``, or None (``run_round``
                  then starts every client from zeros).
    weights:      optional ``(S,)`` aggregation weights.
    solver_slots: the slots of a stateful local solver (``momentum``,
                  ``adam``) as one flat tree of ``(S, ...)`` rows keyed
                  ``"m/<leaf>"``, ``"v/<leaf>"``, ``"t"``
                  (``core.tree.tree_flatten_slots``), else None
                  (``run_round`` then starts every client from
                  ``solver.init``).
    """

    c_i: Any
    uplink_residual: Any = None
    weights: Optional[torch.Tensor] = None
    solver_slots: Any = None


@dataclasses.dataclass
class RoundOutput:
    """Result of one communication round."""

    server: ServerState
    clients: ClientRoundState
    metrics: Dict[str, Any]


# ---------------------------------------------------------------------------
# algorithm strategies
# ---------------------------------------------------------------------------


class Algorithm:
    """One federated algorithm = one strategy over the round template."""

    name: str = ""
    stateful_clients: bool = False
    whole_batch: bool = False
    default_server_optimizer: str = "sgd"

    def local_correction(self, spec, x, c, c_i):
        """Constant per-step correction added to local gradients, or None."""
        return None

    def prox_mu(self, spec) -> float:
        """FedProx proximal coefficient (0 disables the prox term)."""
        return 0.0

    def client_control_update(self, spec, x, y, c, c_i,
                              grad_at_x: Callable[[], Any]
                              ) -> Tuple[Any, Any]:
        """``(c_i_new, dc)`` after the K local steps; ``grad_at_x`` lazily
        computes g_i(x) over the client's round data (option I)."""
        return c_i, tree_zeros_like(c_i)

    def server_control_update(self, spec, c, dc_mean):
        """New server control variate from the aggregated dc."""
        return c


class FedAvg(Algorithm):
    """Plain federated averaging — no correction."""

    name = "fedavg"


class FedProx(Algorithm):
    """FedAvg + a proximal term pulling local steps toward the server
    model (``spec.fedprox_mu``)."""

    name = "fedprox"

    def prox_mu(self, spec) -> float:
        return spec.fedprox_mu


class Scaffold(Algorithm):
    """The paper's Algorithm 1: control-variate-corrected local steps,
    c_i updated by option I or II (``spec.scaffold_option``)."""

    name = "scaffold"
    stateful_clients = True

    def local_correction(self, spec, x, c, c_i):
        # c - c_i, applied every local step (eq. 3)
        return tree_sub(c, c_i)

    def client_control_update(self, spec, x, y, c, c_i, grad_at_x):
        if spec.scaffold_option == "II":
            # c_i+ = c_i - c + (x - y)/(K*eta_l)   (eq. 4, option II)
            inv = 1.0 / (spec.local_steps * spec.eta_l)
            c_i_new = tree_map(
                lambda ci, cc, xx, yy: (ci - cc + inv * (xx - yy)).to(ci.dtype),
                c_i, c, x, y)
        else:
            # c_i+ = g_i(x): extra pass over the client's round data (eq. 4, I)
            c_i_new = tree_map(lambda g, ci: g.to(ci.dtype), grad_at_x(), c_i)
        return c_i_new, tree_sub(c_i_new, c_i)

    def server_control_update(self, spec, c, dc_mean):
        # c+ = c + (S/N) * mean dc   (alg. 1 line 17)
        frac = spec.num_sampled / spec.num_clients
        return tree_map(lambda cc, d: (cc + frac * d).to(cc.dtype), c,
                        dc_mean)


class LargeBatchSGD(Algorithm):
    """The large-batch baseline: one server step on the whole round
    batch, no local work."""

    name = "sgd"
    whole_batch = True


class ScaffoldM(Scaffold):
    """SCAFFOLD with a server heavy-ball step by default."""

    name = "scaffold_m"
    default_server_optimizer = "momentum"


class FedAvgM(FedAvg):
    """FedAvgM (Hsu et al. 2019): FedAvg + server heavy-ball."""

    name = "fedavgm"
    default_server_optimizer = "momentum"


_ALGORITHMS: Dict[str, Algorithm] = {}


def register_algorithm(algo: Algorithm) -> Algorithm:
    """Register an ``Algorithm`` instance under its ``name``."""
    assert algo.name, "Algorithm subclasses must set a name"
    _ALGORITHMS[algo.name] = algo
    return algo


def get_algorithm(name: str) -> Algorithm:
    """Look up a registered algorithm; unknown names fail loudly."""
    try:
        return _ALGORITHMS[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{algorithm_names()}") from None


def algorithm_names() -> Tuple[str, ...]:
    """Sorted names of all registered algorithms."""
    return tuple(sorted(_ALGORITHMS))


for _a in (Scaffold(), FedAvg(), FedProx(), LargeBatchSGD(), ScaffoldM(),
           FedAvgM()):
    register_algorithm(_a)


# ---------------------------------------------------------------------------
# server optimizers
# ---------------------------------------------------------------------------


class ServerOptimizer:
    """Applies the aggregated round delta ``dy_mean`` to the server model;
    ``apply`` returns ``(x_new, opt_state_new, applied_update)``."""

    name: str = ""

    def init(self, spec, x) -> Any:
        return {}

    def apply(self, spec, opt_state, x, dy_mean):
        raise NotImplementedError


class ServerSGD(ServerOptimizer):
    """x+ = x + eta_g * dy_mean  (eq. 5 / alg. 1 line 16)."""

    name = "sgd"

    def apply(self, spec, opt_state, x, dy_mean):
        x_new = tree_map(lambda xx, d: (xx + spec.eta_g * d).to(xx.dtype),
                         x, dy_mean)
        return x_new, opt_state, dy_mean


class ServerMomentum(ServerOptimizer):
    """Heavy-ball on the aggregated delta (FedAvgM-style):
    ``m+ = beta*m + dy; x+ = x + eta_g*m+``, beta =
    ``spec.server_momentum`` (the spec writes 0.9 there for the
    momentum-default algorithms). ``m`` has x's dtype."""

    name = "momentum"

    def init(self, spec, x):
        return {"m": tree_zeros_like(x)}

    def apply(self, spec, opt_state, x, dy_mean):
        beta = spec.server_momentum
        m_new = tree_map(lambda m, d: (beta * m + d).to(m.dtype),
                         opt_state["m"], dy_mean)
        x_new = tree_map(lambda xx, d: (xx + spec.eta_g * d).to(xx.dtype),
                         x, m_new)
        return x_new, {"m": m_new}, m_new


class ServerAdam(ServerOptimizer):
    """FedAdam (Reddi et al. 2021): Adam on the pseudo-gradient
    ``dy_mean``, fp32 moments and an int32 step counter."""

    name = "adam"

    def init(self, spec, x):
        f32 = lambda a: torch.zeros(a.shape, dtype=torch.float32,  # noqa: E731
                                    device=a.device)
        dev = next(iter(x.values())).device
        return {"m": tree_map(f32, x), "v": tree_map(f32, x),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def apply(self, spec, opt_state, x, dy_mean):
        b1, b2, eps = spec.server_beta1, spec.server_beta2, spec.server_eps
        t = opt_state["t"] + 1
        m_new = tree_map(lambda m, d: b1 * m + (1.0 - b1) * d.float(),
                         opt_state["m"], dy_mean)
        v_new = tree_map(
            lambda v, d: b2 * v + (1.0 - b2) * d.float().square(),
            opt_state["v"], dy_mean)
        bc1 = 1.0 - b1 ** t.float()
        bc2 = 1.0 - b2 ** t.float()
        step = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                        m_new, v_new)
        x_new = tree_map(lambda xx, d: (xx + spec.eta_g * d).to(xx.dtype),
                         x, step)
        return x_new, {"m": m_new, "v": v_new, "t": t}, step


_SERVER_OPTIMIZERS: Dict[str, ServerOptimizer] = {}


def register_server_optimizer(opt: ServerOptimizer) -> ServerOptimizer:
    """Register a ``ServerOptimizer`` instance under its ``name``."""
    assert opt.name, "ServerOptimizer subclasses must set a name"
    _SERVER_OPTIMIZERS[opt.name] = opt
    return opt


def get_server_optimizer(name: str) -> ServerOptimizer:
    """Look up a registered server optimizer; unknown names fail loudly."""
    try:
        return _SERVER_OPTIMIZERS[name]
    except KeyError:
        raise KeyError(f"unknown server optimizer {name!r}; registered: "
                       f"{server_optimizer_names()}") from None


def server_optimizer_names() -> Tuple[str, ...]:
    """Sorted names of all registered server optimizers."""
    return tuple(sorted(_SERVER_OPTIMIZERS))


for _o in (ServerSGD(), ServerMomentum(), ServerAdam()):
    register_server_optimizer(_o)


def resolve_server_optimizer(spec) -> str:
    """An explicit ``spec.server_optimizer`` wins; else
    ``server_momentum>0`` selects heavy-ball; else the algorithm's
    default."""
    if getattr(spec, "server_optimizer", ""):
        return spec.server_optimizer
    if spec.server_momentum > 0.0:
        return "momentum"
    return get_algorithm(spec.algorithm).default_server_optimizer


def init_server_state(spec, x) -> ServerState:
    """Fresh ``ServerState`` for model ``x``: zero control variate + the
    resolved server optimizer's initial slots."""
    opt = get_server_optimizer(resolve_server_optimizer(spec))
    return ServerState(x=x, c=tree_zeros_like(x), opt_state=opt.init(spec, x))


# ---------------------------------------------------------------------------
# the scanned multi-round engine
# ---------------------------------------------------------------------------


def store_families(spec):
    """The row families of the scanned engine's client store for this
    spec: ``("c_i",)`` alone (a bare store), or with ``"residual"`` (a
    stateful uplink codec) and ``"solver"`` (a stateful local solver), a
    dict of those keys."""
    from repro_torch.core.compression import get_compressor
    from repro_torch.core.local_solver import (
        get_local_solver,
        resolve_local_solver,
    )

    fams = ("c_i",)
    if get_compressor(spec.compress).stateful:
        fams += ("residual",)
    if get_local_solver(resolve_local_solver(spec)).stateful:
        fams += ("solver",)
    return fams


def scan_round(grad_fn, spec, server: ServerState, client_store, t, *,
               data, batch_fn, sample_key, data_key, comp_key=None,
               priv_key=None, sizes=None,
               use_fused_update: bool = False) -> RoundOutput:
    """One round of the scanned engine at absolute round ``t``: the
    cohort ``device_sample_ids(sample_key, t, N, S)``, its batches
    ``batch_fn(data, ids, data_key.fold_in(t))``, its rows gathered from
    the device store, ``core.rounds.run_round`` (the compression and
    privacy keys folded by ``t``), and the cohort's new rows written
    back into ``client_store`` in place. Returns the round's
    ``RoundOutput``; its ``server`` is new, the store is the caller's."""
    from repro_torch.core.rounds import run_round
    from repro_torch.core.sampling import device_sample_ids
    from repro_torch.core.tree import tree_gather, tree_scatter

    fams = store_families(spec)
    wrapped = len(fams) > 1
    stores = client_store if wrapped else {"c_i": client_store}
    ids = device_sample_ids(sample_key, t, spec.num_clients,
                            spec.num_sampled)
    batches = batch_fn(data, ids, data_key.fold_in(t))
    rows = {name: tree_gather(stores[name], ids) for name in fams}
    clients = ClientRoundState(
        c_i=rows["c_i"], uplink_residual=rows.get("residual"),
        solver_slots=rows.get("solver"),
        weights=None if sizes is None else sizes.index_select(0, ids))
    out = run_round(grad_fn, spec, server, clients, batches,
                    use_fused_update=use_fused_update,
                    comp_key=None if comp_key is None else comp_key.fold_in(t),
                    priv_key=None if priv_key is None else priv_key.fold_in(t),
                    dp_round=t)
    new = {"c_i": out.clients.c_i, "residual": out.clients.uplink_residual,
           "solver": out.clients.solver_slots}
    for name in fams:
        tree_scatter(stores[name], ids, new[name])
    return out


def run_rounds(grad_fn, spec, server: ServerState, client_store, R: int, *,
               data, batch_fn, sample_key, data_key, comp_key=None,
               priv_key=None, start_round=0, sizes=None,
               use_fused_update: bool = False, shard_fn=None):
    """R communication rounds on the device, with no host round trip but
    the privatizer's exact clip: the reference's ``run_rounds``, a loop
    of :func:`scan_round` over rounds ``start_round .. start_round + R -
    1``.

    server:       ``ServerState`` at round ``start_round``.
    client_store: the full client-state store, leaves ``(N, ...)`` on the
                  device: the bare c_i tree, or a dict of the row
                  families the config carries (:func:`store_families`:
                  ``{"c_i"[, "residual"][, "solver"]}``, slot rows flat
                  as ``core.tree.tree_flatten_slots`` keys them). It is
                  updated in place.
    data:         the dataset's device tensors (``dataset.device_data()``).
    batch_fn:     ``(data, ids, key) -> batches`` with leaves ``(S, K, b,
                  ...)`` (``dataset.device_batch_fn(K, b)``).
    sample_key, data_key, comp_key, priv_key: the root keys
                  (``core.streams.stream_key``) of the cohort, data,
                  compression and privacy streams, folded by the round.
    sizes:        optional ``(N,)`` fp32 per-client sizes for
                  ``spec.weighted_aggregation``.

    Every stream is a pure function of (root key, absolute round), so R
    rounds here equal R calls of ``run_round`` on the same streams, and
    any chunking of them, bit for bit. Returns ``(server, client_store,
    metrics)``, each metric stacked ``(R,)`` (the byte counts int64, the
    float64 ``dp_epsilon`` float64).
    """
    if shard_fn is not None:
        raise NotImplementedError("shard_fn: the port runs on one device")
    fams = store_families(spec)
    if len(fams) > 1 and not (isinstance(client_store, dict)
                              and set(fams) <= set(client_store)):
        raise ValueError(
            f"this config carries per-client rows beyond c_i: pass "
            f"client_store as a dict with keys {sorted(fams)} and (N, ...) "
            f"leaves")
    history = []
    for r in range(R):
        out = scan_round(grad_fn, spec, server, client_store,
                         start_round + r, data=data, batch_fn=batch_fn,
                         sample_key=sample_key, data_key=data_key,
                         comp_key=comp_key, priv_key=priv_key, sizes=sizes,
                         use_fused_update=use_fused_update)
        server = out.server
        history.append(out.metrics)
    metrics = {k: (torch.stack([m[k] for m in history])
                   if isinstance(history[0][k], torch.Tensor)
                   else torch.tensor([m[k] for m in history]))
               for k in history[0]} if history else {}
    return server, client_store, metrics
