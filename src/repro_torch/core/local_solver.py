"""The client local-update layer (the JAX package's
``core/local_solver.py``): a registry of local solvers, each two hooks
over explicit slots,

    init(spec, x)                                  -> slots
    step(spec, slots, y, grads, correction, t)     -> (y', slots')

  ``sgd``        the paper's corrected step (eq. 3),
                 ``y <- y - eta_l * (g_i(y) + correction)``; with
                 ``use_fused_update`` it launches the fused update kernel
                 (B1) once per dtype group per step.
  ``momentum``   client heavy-ball on the corrected gradient,
                 ``m <- beta*m + (g + corr); y <- y - eta_l*m``, with an
                 fp32 slot ``m`` that persists per client across rounds;
                 fused, kernel B2.
  ``adam``       Adam on the corrected gradient with fp32 moments ``m``,
                 ``v`` and a step counter ``t``, persisted per client. No
                 kernel: ``use_fused_update`` takes the plain path.
  ``sgd_sched``  sgd with a per-local-step eta table
                 (``optim.schedules.local_eta_table``), the same every
                 round. Its per-step path is plain; the K-step kernel
                 takes the table.

``run_local_steps`` runs the K steps; with ``spec.use_megakernel`` and a
combination the K-step kernel can express (``megakernel_incompatibility``)
all K steps are one launch (B3, or B4 for ``momentum``). ``local_sgd``
is the reference's seed surface over it (the ``sgd`` solver).

Slots are nested dicts over the port's flat trees (``{"m": tree}``,
``{"m": tree, "v": tree, "t": 0-d int32}``); the round engine and the
client store keep them flat (``core.tree.tree_flatten_slots``). The
client's working copy ``y`` is a fresh copy of the model it received,
owned by ``run_local_steps``; every step updates it, and the
param-shaped slots it is given, in place (one param-sized buffer per
client and slot instead of one per step).
"""
from __future__ import annotations

import functools
import types
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ops as fused_ops
from repro_torch.optim.schedules import local_eta_table


class LocalSolver:
    """One client-side local optimizer = init/step over explicit slots.

    stateful:   the slots are per-client state persisted across rounds.
    megakernel: the step is expressible inside the K-step kernel.
    """

    name: str = ""
    stateful: bool = False
    megakernel: bool = False

    def init(self, spec, x) -> Any:
        """Fresh slots for a client holding model ``x`` (zeros for a
        stateful solver: the store's rows of never-sampled clients are
        zeros)."""
        return {}

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False) -> Tuple[Any, Any]:
        """One local update of ``y`` and the slots (in place); returns
        ``(y, slots')``."""
        raise NotImplementedError

    def shard_slots(self, shard_fn, slots):
        """Pin the param-shaped slot entries with ``shard_fn``, the
        caller's param-tree constraint (slots nest param trees under slot
        keys, so a solver with param-sized slots applies it per entry).
        Default: no param-shaped slots, the slots pass through."""
        return slots

    def check_steps(self, spec, slots, k_steps: int) -> None:
        """Validate the slots against the actual number of local steps
        (the batches' leading dimension)."""


def _corrected_fp32(g, corr):
    """``g + corr`` in fp32 (``g`` alone when there is no correction)."""
    return g.float() if corr is None else g.float() + corr.float()


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


class MomentumSolver(LocalSolver):
    """Client heavy-ball on the corrected gradient:
    ``m <- beta*m + (g + corr); y <- y - eta_l*m``, beta =
    ``spec.local_momentum``, fp32 slot. With ``use_fused_update`` and a
    correction the whole step is one launch of B2 per dtype group."""

    name = "momentum"
    stateful = True
    megakernel = True

    def init(self, spec, x):
        return {"m": {k: torch.zeros(v.shape, dtype=torch.float32,
                                     device=v.device)
                      for k, v in x.items()}}

    def shard_slots(self, shard_fn, slots):
        return {"m": shard_fn(slots["m"])}

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False):
        eta, beta, m = spec.eta_l, spec.local_momentum, slots["m"]
        if use_fused_update and correction is not None:
            dev = next(iter(y.values())).device
            fused_ops.scaffold_momentum_update_packed(
                y, grads, correction, m, eta, beta, out=y, m_out=m,
                device=dev)
            return y, slots
        for k, yy in y.items():
            m[k].mul_(beta).add_(_corrected_fp32(
                grads[k], None if correction is None else correction[k]))
            yy.copy_((yy.float() - eta * m[k]).to(yy.dtype))
        return y, slots


class AdamSolver(LocalSolver):
    """Adam on the corrected gradient (Mime / FedAdam-style client step):
    fp32 moments ``m``, ``v`` and a per-client step counter ``t``, all
    persisted across rounds. beta1 = ``spec.local_momentum``, beta2 =
    ``spec.local_beta2``. No kernel."""

    name = "adam"
    stateful = True
    eps = 1e-8

    def init(self, spec, x):
        zeros = lambda v: torch.zeros(v.shape, dtype=torch.float32,  # noqa: E731
                                      device=v.device)
        dev = next(iter(x.values())).device
        return {"m": {k: zeros(v) for k, v in x.items()},
                "v": {k: zeros(v) for k, v in x.items()},
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def shard_slots(self, shard_fn, slots):
        return {"m": shard_fn(slots["m"]), "v": shard_fn(slots["v"]),
                "t": slots["t"]}

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False):
        b1, b2 = spec.local_momentum, spec.local_beta2
        t = slots["t"] + 1
        bc1 = 1.0 - b1 ** t.float()
        bc2 = 1.0 - b2 ** t.float()
        for k, yy in y.items():
            g = _corrected_fp32(
                grads[k], None if correction is None else correction[k])
            m, v = slots["m"][k], slots["v"][k]
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g.square())
            yy.copy_((yy.float() - spec.eta_l * (m / bc1)
                      / (torch.sqrt(v / bc2) + self.eps)).to(yy.dtype))
        slots["t"] = t
        return y, slots


@functools.lru_cache(maxsize=64)
def _eta_table(schedule: str, eta_l: float, k_steps: int, device):
    """The ``(K,)`` fp32 eta table on ``device``, made once and shared
    (read only): a round captured as a CUDA graph copies nothing from the
    host."""
    return torch.tensor(local_eta_table(schedule, eta_l, k_steps),
                        dtype=torch.float32, device=device)


class ScheduledSGDSolver(LocalSolver):
    """sgd with a per-local-step eta_l schedule: the K values of
    ``spec.eta_l_schedule`` (``optim.schedules.local_eta_table``) are a
    ``(K,)`` fp32 slot, indexed by the step. Stateless: the schedule
    restarts every round. The per-step path is plain; the K-step kernel
    takes the table."""

    name = "sgd_sched"
    megakernel = True

    def init(self, spec, x):
        dev = next(iter(x.values())).device
        return {"eta": _eta_table(spec.eta_l_schedule or "constant",
                                  float(spec.eta_l), spec.local_steps, dev)}

    def check_steps(self, spec, slots, k_steps: int) -> None:
        # the table is sized by spec.local_steps; a longer loop would read
        # past it
        assert slots["eta"].shape[0] == k_steps, (
            f"sgd_sched eta table has {slots['eta'].shape[0]} steps but "
            f"the batches carry {k_steps} local steps; spec.local_steps "
            f"must match the batches' leading dim")

    def step(self, spec, slots, y, grads, correction, t_local, *,
             use_fused_update: bool = False):
        # an fp32 0-d eta: the step is taken in fp32 and rounded once, as
        # the reference's fp32 table entry promotes it
        eta = slots["eta"][t_local]
        for k, yy in y.items():
            g = (grads[k] if correction is None
                 else grads[k] + correction[k])
            yy.copy_((yy.float() - eta * g.float()).to(yy.dtype))
        return y, slots


_LOCAL_SOLVERS: Dict[str, LocalSolver] = {}


def register_local_solver(solver: LocalSolver) -> LocalSolver:
    """Register a ``LocalSolver`` instance under its ``name``."""
    assert solver.name, "LocalSolver subclasses must set a name"
    _LOCAL_SOLVERS[solver.name] = solver
    return solver


def get_local_solver(name: str) -> LocalSolver:
    """Look up a registered local solver; unknown names fail loudly."""
    try:
        return _LOCAL_SOLVERS[name]
    except KeyError:
        raise KeyError(f"unknown local solver {name!r}; registered: "
                       f"{local_solver_names()}") from None


def local_solver_names() -> Tuple[str, ...]:
    """Sorted names of all registered local solvers."""
    return tuple(sorted(_LOCAL_SOLVERS))


for _s in (SGDSolver(), MomentumSolver(), AdamSolver(),
           ScheduledSGDSolver()):
    register_local_solver(_s)


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
                          correction, shard_fn, k_steps: int):
    """All K steps in one launch (callers cleared
    :func:`megakernel_incompatibility` first): B3 with sgd's constant or
    sgd_sched's table, B4 with momentum's slot."""
    dev = next(iter(y0.values())).device
    if solver.name == "sgd_sched":
        eta_table = slots["eta"]
    else:
        eta_table = torch.full((k_steps,), spec.eta_l, dtype=torch.float32,
                               device=dev)
    is_momentum = solver.name == "momentum"
    y_K, m_K, losses = mk.scaffold_local_loop(
        y0, correction, batches, eta_table,
        m=slots["m"] if is_momentum else None,
        beta=spec.local_momentum if is_momentum else 0.0, device=dev)
    slots_K = {"m": m_K} if is_momentum else slots
    if shard_fn is not None:
        y_K = shard_fn(y_K)
        slots_K = solver.shard_slots(shard_fn, slots_K)
    return y_K, slots_K, losses.mean()


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
    shard_fn=None,
) -> Tuple[Any, Any, torch.Tensor]:
    """K local solver steps; returns ``(y_K, slots_K, mean local loss)``.

    ``y0`` is not modified: the loop works on its own copy. ``slots=None``
    starts from ``solver.init`` (a fresh client); slots that are passed in
    are the caller's to give up, as the steps update them in place. The
    FedProx prox term, when active, is accumulated in fp32 as in the
    reference. ``shard_fn``, a param-tree constraint, pins the client's
    model and its param-shaped slots after every step (the reference's
    FSDP carry pin).
    """
    if solver is None:
        solver = get_local_solver(resolve_local_solver(spec))
    if slots is None:
        slots = solver.init(spec, y0)
    k_steps = next(iter(batches.values())).shape[0]
    solver.check_steps(spec, slots, k_steps)

    if getattr(spec, "use_megakernel", False) and megakernel_incompatibility(
            grad_fn, solver, prox_mu=prox_mu, params=y0,
            batches=batches) is None:
        return _run_megakernel_steps(
            spec, y0, batches, solver=solver, slots=slots,
            correction=correction, shard_fn=shard_fn, k_steps=k_steps)

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
        if shard_fn is not None:
            y = shard_fn(y)
            slots = solver.shard_slots(shard_fn, slots)
        del grads
        losses.append(metrics["loss"])
    return y, slots, torch.stack(losses).mean()


def local_sgd(grad_fn: Callable, y0, batches, eta_l: float, *,
              correction=None, prox_mu: float = 0.0, prox_center=None,
              use_fused_update: bool = False,
              shard_fn=None) -> Tuple[Any, torch.Tensor]:
    """The reference's back-compat seed surface: K plain corrected SGD
    steps, :func:`run_local_steps` with the ``sgd`` solver; returns
    ``(y_K, mean local loss)``."""
    y, _, loss = run_local_steps(
        grad_fn, types.SimpleNamespace(eta_l=eta_l), y0, batches,
        solver=get_local_solver("sgd"), correction=correction,
        prox_mu=prox_mu, prox_center=prox_center,
        use_fused_update=use_fused_update, shard_fn=shard_fn)
    return y, loss
