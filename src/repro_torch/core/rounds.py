"""One federated communication round (the JAX package's
``core/rounds.py``).

``run_round(grad_fn, spec, server, clients, batches)`` implements
Algorithm 1 (SCAFFOLD) and the ported baselines for the S sampled
clients. The clients run one after another under both strategies; what
differs is the aggregation, which follows the reference exactly:

  client_parallel   dy/dc means over the stacked client deltas (fp32
                    sums), drift = mean of the per-client ||dy||.
  client_sequential a running weighted sum in the model's dtype (the
                    reference's scan carry), drift = ||mean dy||.

Each client's ``c_i`` and solver-slot rows move to the model's device
only while that client runs, and its new rows go straight back over its
input rows, so the device holds one client's state at a time and the
host one copy of the cohort's. Compression, privatization and
non-``full`` update spaces are not ported yet: a spec that asks for them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.api import (
    ClientRoundState,
    RoundOutput,
    ServerState,
    get_algorithm,
    get_server_optimizer,
    resolve_server_optimizer,
)
from repro_torch.core.local_solver import (
    get_local_solver,
    resolve_local_solver,
    run_local_steps,
)
from repro_torch.core.tree import (
    tree_flatten_slots,
    tree_map,
    tree_nest_slots,
    tree_norm,
    tree_sub,
)

# fp32 temporaries of the accumulations are made this many elements at a
# time, so a bf16 leaf never needs a whole fp32 copy beside it
_CHUNK = 1 << 26


def check_ported(spec) -> None:
    """Raise ``NotImplementedError`` for spec knobs whose subsystems are
    not ported yet (the JAX package supports them)."""
    pending = []
    if spec.compress != "none" or spec.compress_downlink != "none":
        pending.append(f"compression ({spec.compress!r}/"
                       f"{spec.compress_downlink!r})")
    if spec.privatizer != "none":
        pending.append(f"privatizer {spec.privatizer!r}")
    if spec.update_space != "full":
        pending.append(f"update space {spec.update_space!r}")
    if pending:
        raise NotImplementedError(", ".join(pending) + ": not ported yet")
    get_algorithm(spec.algorithm)
    get_local_solver(resolve_local_solver(spec))
    get_server_optimizer(resolve_server_optimizer(spec))


def _merge_step_batches(batches):
    """(K, b, ...) leaves -> (K*b, ...) for Option I's pass at x."""
    return {k: a.reshape((-1,) + tuple(a.shape[2:])) for k, a in
            batches.items()}


def client_update(grad_fn, spec, x, c, c_i, batches, solver_slots=None,
                  use_fused_update: bool = False):
    """Local work of one sampled client.

    batches: dict with leaves (K, b, ...). Returns
    ``(dy, dc, c_i_new, solver_slots_new, loss)`` with dy = y_K - x and
    dc = c_i_new - c_i.
    """
    algo = get_algorithm(spec.algorithm)
    correction = algo.local_correction(spec, x, c, c_i)
    prox_mu = algo.prox_mu(spec)
    prox_center = x if prox_mu else None

    y, slots_new, loss = run_local_steps(
        grad_fn, spec, x, batches,
        slots=solver_slots, correction=correction,
        prox_mu=prox_mu, prox_center=prox_center,
        use_fused_update=use_fused_update,
    )
    del correction
    c_i_new, dc = algo.client_control_update(
        spec, x, y, c, c_i,
        lambda: grad_fn(x, _merge_step_batches(batches))[0],
    )
    # dy = y - x, in place: the working copy is not needed any more
    dy = tree_map(lambda yy, xx: yy.sub_(xx), y, x)
    return dy, dc, c_i_new, slots_new, loss


def _whole_batch_round(grad_fn, spec, server, clients, batches) -> RoundOutput:
    """Large-batch SGD baseline: one server step on the whole round batch."""
    flat = {k: a.reshape((-1,) + tuple(a.shape[3:])) for k, a in
            batches.items()}
    grads, metrics = grad_fn(server.x, flat)
    x_new = tree_map(lambda xx, gg: (xx - spec.eta_l * gg).to(xx.dtype),
                     server.x, grads)
    out_metrics = {
        "loss": metrics["loss"],
        "drift": torch.zeros((), dtype=torch.float32),
        "update_norm": tree_norm(tree_sub(x_new, server.x)),
        **round_comm_bytes(spec, server.x, stateful_clients=False),
    }
    return RoundOutput(server=dataclasses.replace(server, x=x_new),
                       clients=clients, metrics=out_metrics)


def tree_bytes(tree) -> int:
    """Bytes of an uncompressed tree (the raw wire size)."""
    return sum(v.numel() * v.element_size() for v in tree.values())


def round_comm_bytes(spec, x, *, stateful_clients: bool) -> Dict[str, int]:
    """Exact per-round communicated bytes (uncompressed): per sampled
    client, dy (+ dc for stateful-client algorithms) up, x (+ c) down."""
    check_ported(spec)
    per = tree_bytes(x)
    per_up = per * (2 if stateful_clients else 1)
    per_down = per * (2 if stateful_clients else 1)
    return {"bytes_up": spec.num_sampled * per_up,
            "bytes_down": spec.num_sampled * per_down}


def _accumulate(acc, w: float, d) -> None:
    """``acc += w * d`` leafwise in place, computed in fp32 and rounded
    once to acc's dtype (a chunk of elements at a time)."""
    for k, a in acc.items():
        af, df = a.view(-1), d[k].reshape(-1)
        for s in range(0, af.numel(), _CHUNK):
            sl = slice(s, s + _CHUNK)
            af[sl] = af[sl].float() + w * df[sl].float()


def run_round(grad_fn, spec, server: ServerState, clients: ClientRoundState,
              batches, use_fused_update: bool = False) -> RoundOutput:
    """One communication round over the S sampled clients.

    server:  ``ServerState`` on the model's device.
    clients: ``ClientRoundState`` — c_i with leaves (S, ...) (host or
             device), the stateful local solver's slot rows (flat, leaves
             (S, ...), or None for fresh slots), optional (S,)
             aggregation weights.
    batches: dict with leaves (S, K, b, ...) on the model's device.

    The client rows are the round's to update: each client's new c_i and
    slot rows are written over its input rows (the host then holds one
    copy of the cohort's state, not two). Returns the new
    ``ServerState``, the new client state (those rows; slot rows only for
    a stateful solver, fresh ones in c_i's placement when none came in)
    and the metrics: ``loss``, ``drift``, ``update_norm`` (0-d tensors)
    and ``bytes_up``/``bytes_down`` (ints).
    """
    check_ported(spec)
    algo = get_algorithm(spec.algorithm)
    if algo.whole_batch:
        return _whole_batch_round(grad_fn, spec, server, clients, batches)

    x, c = server.x, server.c
    dev = next(iter(x.values())).device
    s = spec.num_sampled
    c_i_all, weights = clients.c_i, clients.weights
    stateful_solver = get_local_solver(resolve_local_solver(spec)).stateful
    slots_all = clients.solver_slots if stateful_solver else None
    fresh_slots = slots_all is None  # every client starts from solver.init
    if weights is not None:
        wnorm = weights.float()
        wnorm = (wnorm / torch.clamp(wnorm.sum(), min=1e-12)).tolist()

    parallel = spec.strategy == "client_parallel"
    if parallel:
        # fp32 sums of the stacked deltas (the mean over the client axis)
        dy_acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in x.items()}
        dc_acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in c.items()}
        w_seq = wnorm if weights is not None else [1.0] * s
        norms = []
    else:
        # the reference's scan carry: zeros in the model's dtype
        dy_acc = {k: torch.zeros_like(v) for k, v in x.items()}
        dc_acc = {k: torch.zeros_like(v) for k, v in c.items()}
        w_seq = (wnorm if weights is not None
                 else torch.full((s,), 1.0 / s, dtype=torch.float32).tolist())
    losses = []
    for i in range(s):
        c_i = {k: v[i].to(dev, non_blocking=True) for k, v in c_i_all.items()}
        slots_i = (None if fresh_slots else tree_nest_slots(
            {k: v[i].to(dev, copy=True) for k, v in slots_all.items()}))
        batch_i = {k: v[i] for k, v in batches.items()}
        dy, dc, c_i_new, slots_new, loss = client_update(
            grad_fn, spec, x, c, c_i, batch_i, solver_slots=slots_i,
            use_fused_update=use_fused_update)
        del c_i, slots_i
        if algo.stateful_clients:
            for k, v in c_i_new.items():
                c_i_all[k][i].copy_(v)
        del c_i_new
        if stateful_solver:
            flat = tree_flatten_slots(slots_new)
            if slots_all is None:
                place = next(iter(c_i_all.values())).device
                slots_all = {k: torch.empty((s,) + tuple(v.shape),
                                            dtype=v.dtype, device=place)
                             for k, v in flat.items()}
            for k, v in flat.items():
                slots_all[k][i].copy_(v)
            del flat
        del slots_new
        if parallel:
            norms.append(tree_norm(dy))
        _accumulate(dy_acc, w_seq[i], dy)
        _accumulate(dc_acc, w_seq[i], dc)
        del dy, dc
        losses.append(loss)

    if parallel:
        div = 1.0 if weights is not None else float(s)
        dy_mean = tree_map(lambda a, xx: (a / div).to(xx.dtype), dy_acc, x)
        dc_mean = tree_map(lambda a, cc: (a / div).to(cc.dtype), dc_acc, c)
        del dy_acc, dc_acc
        drift = torch.stack(norms).mean()
    else:
        dy_mean, dc_mean = dy_acc, dc_acc
        drift = tree_norm(dy_mean)
    loss = torch.stack(losses).mean()

    opt = get_server_optimizer(resolve_server_optimizer(spec))
    x_new, opt_state_new, applied = opt.apply(spec, server.opt_state, x,
                                              dy_mean)
    c_new = algo.server_control_update(spec, c, dc_mean)
    metrics = {
        "loss": loss,
        "drift": drift,
        "update_norm": tree_norm(applied),
        **round_comm_bytes(spec, x, stateful_clients=algo.stateful_clients),
    }
    return RoundOutput(
        server=ServerState(x=x_new, c=c_new, opt_state=opt_state_new),
        clients=ClientRoundState(c_i=c_i_all, weights=weights,
                                 solver_slots=slots_all),
        metrics=metrics,
    )
