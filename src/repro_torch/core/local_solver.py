"""The client local-update layer (the JAX package's
``core/local_solver.py``).

The ``sgd`` solver is the paper's corrected step (eq. 3),

    y <- y - eta_l * (g_i(y) + correction)

and with ``use_fused_update`` it routes through the fused update kernel
(one launch per dtype group per step). ``run_local_steps`` runs the K
steps; with ``spec.use_megakernel`` and a combination the K-step kernel
can express (``megakernel_incompatibility``) all K steps are one launch.
The JAX package's other solvers (``momentum``, ``adam``, ``sgd_sched``)
raise ``NotImplementedError`` when looked up.

The client's working copy ``y`` is a fresh copy of the model it received,
owned by ``run_local_steps``, and every step updates it in place (one
param-sized buffer per client instead of one per step).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ops as fused_ops


class LocalSolver:
    """One client-side local optimizer = init/step over explicit slots.

    stateful:   the slots are per-client state persisted across rounds.
    megakernel: the step is expressible inside the K-step kernel.
    """

    name: str = ""
    stateful: bool = False
    megakernel: bool = False

    def init(self, spec, x) -> Any:
        """Fresh slots for a client holding model ``x``."""
        return {}

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False) -> Tuple[Any, Any]:
        """One local update of ``y`` (in place); returns ``(y, slots')``."""
        raise NotImplementedError


class SGDSolver(LocalSolver):
    """The paper's corrected local step (eq. 3), with the fused-kernel
    routing of the reference (``core/local_solver.py:145-148``)."""

    name = "sgd"
    megakernel = True

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False):
        eta = spec.eta_l
        if correction is not None:
            if use_fused_update:
                dev = next(iter(y.values())).device
                fused_ops.scaffold_update_packed(y, grads, correction, eta,
                                                 out=y, device=dev)
            else:
                for k, yy in y.items():
                    yy.copy_((yy - eta * (grads[k] + correction[k]))
                             .to(yy.dtype))
        else:
            for k, yy in y.items():
                yy.copy_((yy - eta * grads[k]).to(yy.dtype))
        return y, slots


_LOCAL_SOLVERS: Dict[str, LocalSolver] = {}
_NOT_PORTED_SOLVERS = ("momentum", "adam", "sgd_sched")


def register_local_solver(solver: LocalSolver) -> LocalSolver:
    """Register a ``LocalSolver`` instance under its ``name``."""
    assert solver.name, "LocalSolver subclasses must set a name"
    _LOCAL_SOLVERS[solver.name] = solver
    return solver


def get_local_solver(name: str) -> LocalSolver:
    """Look up a registered local solver; unknown names fail loudly."""
    if name in _NOT_PORTED_SOLVERS:
        raise NotImplementedError(f"local solver {name!r}: not ported yet")
    try:
        return _LOCAL_SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown local solver {name!r}; registered: "
                       f"{local_solver_names()}") from None


def local_solver_names() -> Tuple[str, ...]:
    """Sorted names of all registered (ported) local solvers."""
    return tuple(sorted(_LOCAL_SOLVERS))


register_local_solver(SGDSolver())


def resolve_local_solver(spec) -> str:
    """The spec's local solver name ("sgd" when unset)."""
    return getattr(spec, "local_solver", "") or "sgd"


# ---------------------------------------------------------------------------
# the K-step local loop
# ---------------------------------------------------------------------------


def megakernel_incompatibility(grad_fn, solver: LocalSolver, *,
                               prox_mu: float = 0.0, params=None,
                               batches=None):
    """Why this (grad_fn, solver, problem) combination can NOT take the
    K-step kernel path — None when it can. The strings are the JAX
    package's, word for word; engines surface them as
    ``megakernel_fallback_reason``."""
    marker = getattr(grad_fn, "megakernel_grad", None)
    if marker != "quadratic":
        return ("grad not kernel-expressible (loss_fn lacks "
                "megakernel_grad='quadratic')")
    if not getattr(solver, "megakernel", False):
        return f"local solver {solver.name!r} has no megakernel variant"
    if prox_mu:
        return "FedProx prox term is not expressible in the megakernel"
    if params is not None:
        leaves = list(params.values())
        if len(leaves) != 1 or leaves[0].dim() != 1:
            return "params are not a single 1-D leaf"
    if batches is not None and not (
            isinstance(batches, dict) and "A" in batches and "b" in batches):
        return "batches are not quadratic (A, b) pairs"
    return None


def _run_megakernel_steps(spec, y0, batches, *, solver: LocalSolver, slots,
                          correction, k_steps: int):
    """All K steps in one launch (callers cleared
    :func:`megakernel_incompatibility` first)."""
    dev = next(iter(y0.values())).device
    eta_table = torch.full((k_steps,), spec.eta_l, dtype=torch.float32,
                           device=dev)
    y_K, _, losses = mk.scaffold_local_loop(y0, correction, batches,
                                            eta_table, device=dev)
    return y_K, slots, losses.mean()


def run_local_steps(
    grad_fn: Callable,
    spec,
    y0,
    batches,  # dict, leaves (K, b, ...)
    *,
    solver: LocalSolver | None = None,
    slots=None,
    correction=None,
    prox_mu: float = 0.0,
    prox_center=None,
    use_fused_update: bool = False,
) -> Tuple[Any, Any, torch.Tensor]:
    """K local solver steps; returns ``(y_K, slots_K, mean local loss)``.

    ``y0`` is not modified: the loop works on its own copy. The FedProx
    prox term, when active, is accumulated in fp32 as in the reference.
    """
    if solver is None:
        solver = get_local_solver(resolve_local_solver(spec))
    if slots is None:
        slots = solver.init(spec, y0)
    k_steps = next(iter(batches.values())).shape[0]

    if getattr(spec, "use_megakernel", False) and megakernel_incompatibility(
            grad_fn, solver, prox_mu=prox_mu, params=y0,
            batches=batches) is None:
        return _run_megakernel_steps(
            spec, y0, batches, solver=solver, slots=slots,
            correction=correction, k_steps=k_steps)

    y = {k: v.clone() for k, v in y0.items()}
    losses = []
    for t in range(k_steps):
        batch = {k: v[t] for k, v in batches.items()}
        grads, metrics = grad_fn(y, batch)
        if prox_mu:
            grads = {k: g.float() + prox_mu * (y[k].float()
                                               - prox_center[k].float())
                     for k, g in grads.items()}
        y, slots = solver.step(spec, slots, y, grads, correction, t,
                               use_fused_update=use_fused_update)
        del grads
        losses.append(metrics["loss"])
    return y, slots, torch.stack(losses).mean()
