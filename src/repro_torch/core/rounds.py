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

Each client's ``c_i``, residual and solver-slot rows move to the model's
device only while that client runs, and its new rows go straight back
over its input rows, so the device holds one client's state at a time
and the host one copy of the cohort's. Nothing in a round reads a value
back to the host but the privatizer's exact clip, so the scanned engine
can capture a round as a CUDA graph (``core.controller``).

Compression and privacy follow the reference's order. The downlink codec
transforms the broadcast ``(x, c)``; the clients start from what they
received and measure dy against it, while the server applies the mean
to its exact x. Per client: clip dy (``spec.privatizer``), add the
client's noise, then round-trip dy through the uplink codec with the
client's error-feedback residual. Server noise lands on the mean before
the server optimizer. The control stream dc is never compressed or
noised. The round is generic over ``server.x``: under an update space
that trains a subset (``core/update_space.py``) it is the delta tree,
and every state and byte count follows it.

``client_block`` is one client of that loop (rows in, client update,
clip, noise, codec, rows written back); the async engine's dispatch
groups run their clients through it too.

``federated_round`` is the reference's tuple-returning shim over
``run_round`` (its seed signature).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.api import (
    ClientRoundState,
    RoundOutput,
    ServerState,
    get_algorithm,
    get_server_optimizer,
    resolve_server_optimizer,
)
from repro_torch.core.compression import get_compressor, round_comm_bytes
from repro_torch.core.local_solver import (
    get_local_solver,
    resolve_local_solver,
    run_local_steps,
)
from repro_torch.core.privatizer import get_privatizer
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
        "drift": torch.zeros((), dtype=torch.float32,
                             device=metrics["loss"].device),
        "update_norm": tree_norm(tree_sub(x_new, server.x)),
        **round_comm_bytes(spec, server.x, stateful_clients=False),
    }
    return RoundOutput(server=dataclasses.replace(server, x=x_new),
                       clients=clients, metrics=out_metrics)


def _accumulate(acc, w, d) -> None:
    """``acc += w * d`` leafwise in place, computed in fp32 and rounded
    once to acc's dtype (a chunk of elements at a time); ``w`` a float or
    an fp32 0-d tensor."""
    for k, a in acc.items():
        af, df = a.view(-1), d[k].reshape(-1)
        for s in range(0, af.numel(), _CHUNK):
            sl = slice(s, s + _CHUNK)
            af[sl] = af[sl].float() + w * df[sl].float()


def _rows_to(rows, i, dev, copy=False):
    """Row ``i`` of a family of ``(S, ...)`` rows, on ``dev`` (a copy the
    caller owns with ``copy``)."""
    return {k: v[i].to(dev, non_blocking=not copy, copy=copy)
            for k, v in rows.items()}


def _write_row(rows, i, new, s: int, place):
    """Write a client's new rows over row ``i`` of ``rows``; when the
    round brought none, first allocate ``(s, ...)`` rows on ``place``
    (every client of the round then fills its own). Returns ``rows``."""
    if rows is None:
        rows = {k: torch.empty((s,) + tuple(v.shape), dtype=v.dtype,
                               device=place) for k, v in new.items()}
    for k, v in new.items():
        rows[k][i].copy_(v)
    return rows


def client_block(grad_fn, spec, x_cl, c_cl, rows: ClientRoundState, i: int,
                 batch, *, fresh_slots: bool, dev, k_up=None, k_priv=None,
                 position=None, use_fused_update: bool = False):
    """Client ``i`` of a cohort as a round runs it: its rows to ``dev``,
    ``client_update`` from the broadcast ``(x_cl, c_cl)``, then the clip,
    the client's noise and the uplink codec's round trip.

    rows:     the cohort's ``c_i``, residual and slot rows (leaves
              ``(n, ...)``, host or device). The client's new rows are
              written over row ``i`` as soon as each is made (residual and
              slot rows allocated ``(n, ...)`` in c_i's placement when
              none came in), so the device holds one client's state.
    batch:    the client's batches, leaves ``(K, b, ...)`` on ``dev``.
    fresh_slots: the client starts from ``solver.init`` (no slot rows
              came into the round).
    position: the client's fold in the keyed draws (default ``i``):
              the codec draws at ``k_up.fold_in(position)``, the noise at
              ``k_priv.fold_in(position)``.

    The round and the async engine's dispatch groups both run clients
    through this block. Returns ``(rows, dy, dc, loss, clip_flag)``:
    the row families, the post-codec delta, the control delta, the loss
    and the clip flag (None unless the privatizer clips).
    """
    algo = get_algorithm(spec.algorithm)
    up = get_compressor(spec.compress)
    priv = get_privatizer(spec.privatizer)
    stateful_solver = get_local_solver(resolve_local_solver(spec)).stateful
    position = i if position is None else position
    c_i_all = rows.c_i
    lead = next(iter(c_i_all.values()))
    n, place = lead.shape[0], lead.device
    slots_all, res_all = rows.solver_slots, rows.uplink_residual
    c_i = _rows_to(c_i_all, i, dev)
    slots_i = (None if fresh_slots else
               tree_nest_slots(_rows_to(slots_all, i, dev, copy=True)))
    dy, dc, c_i_new, slots_new, loss = client_update(
        grad_fn, spec, x_cl, c_cl, c_i, batch, solver_slots=slots_i,
        use_fused_update=use_fused_update)
    del c_i, slots_i
    if algo.stateful_clients:
        _write_row(c_i_all, i, c_i_new, n, place)
    del c_i_new
    if stateful_solver:
        slots_all = _write_row(slots_all, i, tree_flatten_slots(slots_new),
                               n, place)
    del slots_new
    flag = None
    if priv.name != "none" and priv.clips:
        # clip -> (client noise) -> compress: the codec sees a
        # norm-bounded, already-noised delta
        dy, flag = priv.clip(spec, dy)
        if priv.noise_at == "client":
            dy = priv.client_noise(spec, dy, k_priv.fold_in(position))
    if up.name != "none":
        res_i = None if res_all is None else _rows_to(res_all, i, dev)
        dy, res_new = up.round_trip(
            spec, dy, res_i,
            key=k_up.fold_in(position) if up.needs_key else None)
        if up.stateful:
            res_all = _write_row(res_all, i, res_new, n, place)
        del res_i, res_new
    rows = dataclasses.replace(rows, uplink_residual=res_all,
                               solver_slots=slots_all)
    return rows, dy, dc, loss, flag


def run_round(grad_fn, spec, server: ServerState, clients: ClientRoundState,
              batches, use_fused_update: bool = False, comp_key=None,
              priv_key=None, dp_round=None) -> RoundOutput:
    """One communication round over the S sampled clients.

    server:   ``ServerState`` on the model's device.
    clients:  ``ClientRoundState`` — c_i with leaves (S, ...) (host or
              device), the uplink codec's residual rows (None starts
              from zeros), the stateful local solver's slot rows (flat,
              leaves (S, ...), or None for fresh slots), optional (S,)
              aggregation weights.
    batches:  dict with leaves (S, K, b, ...) on the model's device.
    comp_key: this round's compression key (``core.streams.round_key(
              seed + 2, t, device)``), needed when a codec is keyed
              (``randk_ef``): client ``i`` draws ``fold_in(0).fold_in(i)``
              and the downlink ``fold_in(1)``.
    priv_key: this round's privacy key (``round_key(seed + 3, t, ...)``),
              needed by a noise-adding privatizer: client ``i`` draws
              ``fold_in(0).fold_in(i)``, the server ``fold_in(1)``.
    dp_round: the absolute round index, needed when privatizing (the
              metric ``dp_epsilon`` is ``epsilon(dp_round + 1)``).

    The client rows are the round's to update: each client's new c_i,
    residual and slot rows are written over its input rows (the host
    then holds one copy of the cohort's state, not two). Returns the new
    ``ServerState``, the new client state (those rows; residual and slot
    rows allocated in c_i's placement when none came in) and the
    metrics: ``loss``, ``drift``, ``update_norm`` (0-d tensors),
    ``bytes_up``/``bytes_down`` (ints) and, when privatizing,
    ``dp_epsilon`` (the float64 accountant after ``dp_round + 1``
    rounds) and ``dp_clipped_frac`` (a 0-d tensor).
    """
    algo = get_algorithm(spec.algorithm)
    if algo.whole_batch:
        return _whole_batch_round(grad_fn, spec, server, clients, batches)

    up = get_compressor(spec.compress)
    down = get_compressor(spec.compress_downlink)
    priv = get_privatizer(spec.privatizer)
    privatizing = priv.name != "none"
    if ((up.needs_key or down.needs_key) and comp_key is None
            or privatizing and (priv_key is None or dp_round is None)):
        raise ValueError(
            f"codecs {up.name!r}/{down.name!r} and privatizer {priv.name!r}:"
            f" pass comp_key (a keyed codec), priv_key and dp_round (a "
            f"privatizer) to run_round")
    k_up = comp_key.fold_in(0) if comp_key is not None else None
    k_priv = priv_key.fold_in(0) if priv_key is not None else None

    x, c = server.x, server.c
    dev = next(iter(x.values())).device
    # what the clients receive: the (optionally compressed) broadcast;
    # dy is measured against it, the server applies to the exact x
    if down.name != "none":
        x_cl, c_cl = down.apply_stateless(
            spec, (x, c),
            key=comp_key.fold_in(1) if comp_key is not None else None)
    else:
        x_cl, c_cl = x, c

    s = spec.num_sampled
    c_i_all, weights = clients.c_i, clients.weights
    stateful_solver = get_local_solver(resolve_local_solver(spec)).stateful
    slots_all = clients.solver_slots if stateful_solver else None
    fresh_slots = slots_all is None  # every client starts from solver.init
    res_all = clients.uplink_residual
    if weights is not None:
        # the normalised weights stay tensors (0-d fp32 a client): no
        # host round trip inside a round
        wnorm = weights.float()
        wnorm = list((wnorm / torch.clamp(wnorm.sum(), min=1e-12)).unbind())

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
    losses, clip_flags = [], []
    rows = ClientRoundState(c_i=c_i_all, uplink_residual=res_all,
                            weights=weights, solver_slots=slots_all)
    for i in range(s):
        rows, dy, dc, loss, flag = client_block(
            grad_fn, spec, x_cl, c_cl, rows, i,
            {k: v[i] for k, v in batches.items()}, fresh_slots=fresh_slots,
            dev=dev, k_up=k_up, k_priv=k_priv,
            use_fused_update=use_fused_update)
        if flag is not None:
            clip_flags.append(flag)
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

    # trusted-aggregator noise lands on the mean, after the codec and
    # before the server optimizer
    if privatizing and priv.noise_at == "server":
        dy_mean = priv.server_noise(spec, dy_mean, priv_key.fold_in(1))

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
    if privatizing:
        metrics["dp_epsilon"] = priv.epsilon(spec, dp_round + 1)
        if clip_flags:
            metrics["dp_clipped_frac"] = torch.stack(clip_flags).mean()
    return RoundOutput(
        server=ServerState(x=x_new, c=c_new, opt_state=opt_state_new),
        clients=rows,
        metrics=metrics,
    )


def federated_round(grad_fn, spec, x, c, c_i, batches, momentum=None,
                    weights=None, uplink_res=None,
                    use_fused_update: bool = False, comp_key=None):
    """The reference's back-compat shim over :func:`run_round` (its seed
    signature; the port has no ``shard_fn``).

    x, c: the server model and control variate; c_i: the sampled clients'
    control variates, leaves (S, ...), written over in place as
    ``run_round`` writes its rows; batches: leaves (S, K, b, ...).
    ``momentum`` is the server heavy-ball slot, required when the spec
    resolves to the momentum server optimizer; ``uplink_res`` the
    codec's residual rows. Returns ``(x, c, c_i, [momentum],
    [uplink_res], metrics)``, the bracketed entries when they apply
    (never for a whole-batch algorithm).
    """
    opt_name = resolve_server_optimizer(spec)
    assert opt_name in ("sgd", "momentum"), (
        f"the tuple-shim only carries sgd/momentum server state; use "
        f"run_round + ServerState for {opt_name!r}")
    solver_name = resolve_local_solver(spec)
    assert not get_local_solver(solver_name).stateful, (
        f"the tuple-shim cannot carry the per-client slots of stateful "
        f"local solver {solver_name!r} (they would silently reset every "
        f"call); use run_round + ClientRoundState.solver_slots")
    whole_batch = get_algorithm(spec.algorithm).whole_batch
    if opt_name == "momentum" and not whole_batch:
        assert momentum is not None, "pass momentum state for server_momentum"
    opt_state = {"m": momentum} if momentum is not None else {}
    out = run_round(
        grad_fn, spec, ServerState(x=x, c=c, opt_state=opt_state),
        ClientRoundState(c_i=c_i, uplink_residual=uplink_res,
                         weights=weights),
        batches, use_fused_update=use_fused_update, comp_key=comp_key)
    if whole_batch:
        return out.server.x, out.server.c, out.clients.c_i, out.metrics
    outs = [out.server.x, out.server.c, out.clients.c_i]
    if opt_name == "momentum":
        outs.append(out.server.opt_state["m"])
    if spec.compress_uplink:
        outs.append(out.clients.uplink_residual)
    outs.append(out.metrics)
    return tuple(outs)
