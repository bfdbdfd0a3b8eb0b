"""The port's local-solver layer against the JAX package's: the megakernel
capability gate's reason strings, word for word, and ``run_local_steps``
on the quadratics substrate (per-step plain, per-step fused, and the
K-step kernel path; the JAX side under ``force_interpret()``), rtol 1e-5.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import local_solver as jls
from repro.core.controller import make_grad_fn as jax_make_grad_fn
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.kernels.scaffold_update.ops import force_interpret
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.core import local_solver as tls
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import quadratic_loss


def _loss_without_marker(params, batch):
    return quadratic_loss(params, batch)


def _jax_loss_without_marker(params, batch):
    return jax_quadratic_loss(params, batch)


CASES = {
    "ok": dict(),
    "no_marker": dict(unmarked=True),
    "solver": dict(solver="adam"),
    "prox": dict(prox_mu=1.0),
    "two_leaves": dict(params=[(4,), (4,)]),
    "matrix_leaf": dict(params=[(4, 4)]),
    "not_quadratic": dict(batches={"tokens": (2, 3)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_megakernel_incompatibility_strings(case):
    c = CASES[case]
    shapes = c.get("params", [(4,)])
    jp = {f"p{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    tp = {f"p{i}": torch.zeros(s) for i, s in enumerate(shapes)}
    jb = tb = None
    if "batches" in c:
        jb = {k: jnp.zeros(s) for k, s in c["batches"].items()}
        tb = {k: torch.zeros(s) for k, s in c["batches"].items()}
    jgrad = jax_make_grad_fn(_jax_loss_without_marker if c.get("unmarked")
                             else jax_quadratic_loss)
    tgrad = make_grad_fn(_loss_without_marker if c.get("unmarked")
                         else quadratic_loss)
    jsolver = jls.get_local_solver(c.get("solver", "sgd"))
    tsolver = tls.get_local_solver(c.get("solver", "sgd"))
    want = jls.megakernel_incompatibility(
        jgrad, jsolver, prox_mu=c.get("prox_mu", 0.0), params=jp, batches=jb)
    got = tls.megakernel_incompatibility(
        tgrad, tsolver, prox_mu=c.get("prox_mu", 0.0), params=tp, batches=tb)
    assert got == want
    assert (want is None) == (case == "ok")


def _quad_problem(d=24, K=5, seed=0):
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    A = np.broadcast_to((M @ M.T + 0.1 * np.eye(d, dtype=np.float32)),
                        (K, 1, d, d)).copy()
    b = np.broadcast_to(rng.standard_normal(d).astype(np.float32),
                        (K, 1, d)).copy()
    y0 = rng.standard_normal(d).astype(np.float32)
    corr = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return y0, corr, A, b


@pytest.mark.parametrize("path", ["plain", "fused", "megakernel"])
@pytest.mark.parametrize("with_corr", [True, False])
def test_run_local_steps_matches_reference(path, with_corr):
    y0, corr, A, b = _quad_problem()
    kw = dict(algorithm="scaffold", num_clients=2, num_sampled=1,
              local_steps=5, local_batch=1, eta_l=0.1,
              use_megakernel=path == "megakernel")
    fused = path != "plain"
    with force_interpret():
        yj, _, lj = jls.run_local_steps(
            jax_make_grad_fn(jax_quadratic_loss), JSpec(**kw),
            {"x": jnp.asarray(y0)}, {"A": jnp.asarray(A), "b": jnp.asarray(b)},
            correction={"x": jnp.asarray(corr)} if with_corr else None,
            use_fused_update=fused)
    y0_t = {"x": torch.from_numpy(y0.copy())}
    yt, _, lt = tls.run_local_steps(
        make_grad_fn(quadratic_loss), TSpec(**kw), y0_t,
        {"A": torch.from_numpy(A), "b": torch.from_numpy(b)},
        correction={"x": torch.from_numpy(corr)} if with_corr else None,
        use_fused_update=fused)
    assert torch.equal(y0_t["x"], torch.from_numpy(y0))  # y0 not modified
    yj = np.asarray(yj["x"])
    assert np.abs(yt["x"].numpy() - yj).max() <= 1e-5 * np.abs(yj).max()
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))


def test_not_ported_solvers_raise():
    """Every solver of the reference is registered (none is left
    unported), with the reference's flags; an unknown name raises."""
    assert tls.local_solver_names() == jls.local_solver_names() == (
        "adam", "momentum", "sgd", "sgd_sched")
    for name in tls.local_solver_names():
        got, want = tls.get_local_solver(name), jls.get_local_solver(name)
        assert (got.stateful, got.megakernel) == (want.stateful,
                                                 want.megakernel), name
    with pytest.raises(KeyError, match="unknown local solver 'lion'"):
        tls.get_local_solver("lion")


def test_duck_typed_spec_defaults_to_sgd():
    assert tls.resolve_local_solver(types.SimpleNamespace()) == "sgd"
