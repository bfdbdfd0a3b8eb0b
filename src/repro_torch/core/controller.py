"""Host-side federated training controller (the JAX package's
``core/controller.py``), synchronous mode.

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

The pipelined, scanned, tiered and async modes are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.api import (
    ClientRoundState,
    get_algorithm,
    init_server_state,
)
from repro_torch.core.compression import get_compressor, round_comm_bytes
from repro_torch.core.local_solver import (
    get_local_solver,
    megakernel_incompatibility,
    resolve_local_solver,
)
from repro_torch.core.rounds import run_round
from repro_torch.core.sampling import ClientSampler
from repro_torch.core.store import ClientStateStore
from repro_torch.core.streams import (
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


class FederatedTrainer:
    """Runs the ported federated algorithms against a federated dataset
    whose ``round_batches(ids, K, b, rng, device=...)`` returns a dict
    with leaves (S, K, b, ...).

    ``init_params(generator)`` builds the initial model from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (a callable
    that ignores it, e.g. one returning converted JAX weights, is fine);
    the leaves are moved to ``device``. ``device`` defaults to the card
    and raises where there is none.
    """

    def __init__(self, loss_fn, init_params, spec, dataset, *, seed: int = 0,
                 use_fused_update: bool = False, device="cuda",
                 pipeline_depth: int = 0, scan_rounds: int = 0,
                 store: str = "dense", store_backend: str = "",
                 async_buffer: int = 0):
        self.device = resolve_device(device)
        pending = []
        if pipeline_depth:
            pending.append("pipelined engine (pipeline_depth)")
        if scan_rounds:
            pending.append("scanned engine (scan_rounds)")
        if store != "dense":
            pending.append(f"store {store!r}")
        if async_buffer:
            pending.append("async engine (async_buffer)")
        if pending:
            raise NotImplementedError(", ".join(pending) + ": not ported yet")
        self.spec = spec
        self.dataset = dataset
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
        self.store = ClientStateStore(self.server.x, spec.num_clients,
                                      backend=store_backend)
        # templates built on the meta device: the stores read only their
        # shapes and dtypes
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in self.server.x.items()}
        # the uplink codec's fp32 error-feedback residuals persist per
        # client across rounds (a stateful codec only)
        self.compressor = get_compressor(spec.compress)
        self.residual_store = None
        if self.compressor.stateful:
            self.residual_store = ClientStateStore(
                {k: v.float() for k, v in meta.items()}, spec.num_clients,
                backend=store_backend)
        self.local_solver = get_local_solver(resolve_local_solver(spec))
        # a stateful local solver's slots persist per client across
        # rounds: one more host row family, zeros for clients never
        # sampled
        self.solver_store = None
        if self.local_solver.stateful:
            self.solver_store = ClientStateStore(
                tree_flatten_slots(self.local_solver.init(spec, meta)),
                spec.num_clients, backend=store_backend)
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

    def host_rng_state(self) -> Dict[str, Any]:
        """The sampler's and the data stream's numpy states, and the
        keyed streams' root keys (stateless in the round index, so their
        seeds are all they need), under the reference's keys."""
        return {"sampler": self.sampler.get_state(),
                "data_rng": self._rng.bit_generator.state,
                "comp_key": key_state(self._comp_seed),
                "priv_key": key_state(self._priv_seed)}

    def set_host_rng_state(self, state: Dict[str, Any]) -> None:
        self.sampler.set_state(state["sampler"])
        self._rng.bit_generator.state = state["data_rng"]
        if "comp_key" in state:
            self._comp_seed = base_from_state(state["comp_key"])
        if "priv_key" in state:
            self._priv_seed = base_from_state(state["priv_key"])

    # -- the synchronous round loop ----------------------------------------

    def run_round(self) -> Dict[str, Any]:
        """Sample, gather, load, run one round, scatter; returns the
        round's metrics (also appended to ``history``)."""
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
        t = self.round_idx
        out = run_round(self._grad_fn, self.spec, self.server,
                        ClientRoundState(c_i=c_i, uplink_residual=res,
                                         weights=weights,
                                         solver_slots=slots), batches,
                        use_fused_update=self._use_fused_update,
                        comp_key=round_key(self._comp_seed, t, self.device),
                        priv_key=round_key(self._priv_seed, t, self.device),
                        dp_round=t)
        del batches, c_i, res, slots
        self.server = out.server
        if self.algorithm.stateful_clients:
            self.store.scatter(ids, out.clients.c_i)
        if self.residual_store is not None:
            self.residual_store.scatter(ids, out.clients.uplink_residual)
        if self.solver_store is not None:
            self.solver_store.scatter(ids, out.clients.solver_slots)
        self.round_idx += 1
        m = {k: float(v) for k, v in out.metrics.items()}
        m.update(self._comm_bytes)
        if self.megakernel_fallback_reason is not None:
            m["megakernel_fallback_reason"] = self.megakernel_fallback_reason
        if self.update_space.trains_subset:
            m["update_space"] = self.update_space.name
        m["round"] = self.round_idx
        self.history.append(m)
        return m

    def run(self, rounds: int, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 0, target_metric: Optional[float] = None,
            metric_name: str = "accuracy", verbose: bool = False):
        """Run rounds; with ``target_metric``, stop once
        ``eval_fn(x)[metric_name] >= target`` and return the rounds used."""
        for r in range(rounds):
            m = self.run_round()
            if eval_fn is not None and eval_every and (r + 1) % eval_every == 0:
                em = eval_fn(self.eval_params())
                m.update(em)
                if verbose:
                    print(f"round {r+1}: {m}")
                if (target_metric is not None
                        and em[metric_name] >= target_metric):
                    return r + 1
        return rounds

    def close(self) -> None:
        """Release the host stores."""
        self.store.close()
        if self.residual_store is not None:
            self.residual_store.close()
        if self.solver_store is not None:
            self.solver_store.close()
