"""The stateful local solvers and the other algorithms and server
optimizers through the port's ``FederatedTrainer``, against the JAX
package's on the same seeds, data and initial weights.

  * similarity quadratics, N=8, S=3, K=4, 4 rounds, over the local
    solvers (``momentum``, ``adam``, ``sgd_sched``) x the algorithms
    (``scaffold``, ``scaffold_m``, ``fedavgm``, ``fedprox``) x the server
    optimizers (``momentum``, ``adam``): the same cohorts, x every round
    to rel 1e-5, and after the last round the server optimizer's slots
    and the client store's solver rows (m, v to rel 1e-5, adam's step
    counter t equal), which shows that the slots persist across rounds;
  * a 2-layer fp32 reduced llama, SCAFFOLD with local ``momentum`` through
    the fused update, 2 rounds: x, c and both client stores to rel 1e-4.
"""
import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import SyntheticLMFederated as JLM
from repro.data import make_similarity_quadratics as jax_sim
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.core.tree import tree_flatten_slots
from repro_torch.data import SyntheticLMFederated
from repro_torch.data import make_similarity_quadratics, quadratic_loss
from repro_torch.models import model as TM

N, S, K, D = 8, 3, 4, 16


def _record_cohorts(trainer):
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def _assert_close(got: dict, want: dict, rel: float):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v.dtype == torch.int32:
            assert torch.equal(got[k], v), k
        else:
            assert ((got[k].double() - v.double()).abs().max()
                    <= rel * max(float(v.abs().max()), 1e-30)), k


GRID = list(itertools.product(["momentum", "adam", "sgd_sched"],
                              ["scaffold", "scaffold_m", "fedavgm", "fedprox"],
                              ["momentum", "adam"]))


@pytest.mark.parametrize("solver,algo,server_opt", GRID,
                         ids=["-".join(c) for c in GRID])
def test_quadratics_trainer_matches_reference(solver, algo, server_opt):
    kw = dict(algorithm=algo, num_clients=N, num_sampled=S, local_steps=K,
              local_batch=1, eta_l=0.05, local_solver=solver,
              server_optimizer=server_opt,
              eta_g=0.1 if server_opt == "adam" else 1.0,
              eta_l_schedule="cosine" if solver == "sgd_sched" else "",
              # both client strategies, one per algorithm family member
              strategy=("client_sequential" if algo in ("scaffold_m",
                                                        "fedprox")
                        else "client_parallel"))
    jds = jax_sim(N, D, delta=0.3, G=2.0, mu=0.3)
    tds = make_similarity_quadratics(N, D, delta=0.3, G=2.0, mu=0.3)
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((D,), jnp.float32)},
                  JSpec(**kw), jds, seed=1, use_fused_update=True)
    tt = FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(D)},
                          TSpec(**kw), tds, seed=1, use_fused_update=True,
                          device="cpu")
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    for _ in range(4):
        mj, mt = jt.run_round(), tt.run_round()
        xj = np.asarray(jt.x["x"])
        assert (np.abs(tt.x["x"].numpy() - xj).max()
                <= 1e-5 * np.abs(xj).max())
        assert abs(mt["loss"] - mj["loss"]) <= 1e-5 * abs(mj["loss"])
    assert cj == ct
    server = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    # the server optimizer's slots, nested like a solver's
    _assert_close(tree_flatten_slots(tt.server.opt_state),
                  tree_flatten_slots(server.opt_state), 1e-5)
    everyone = np.arange(N)
    if solver == "sgd_sched":  # stateless: no slot rows anywhere
        assert tt.solver_store is None and jt.solver_store is None
        return
    want = state_from_jax(jax.tree.map(
        np.asarray, jt.solver_store.gather(everyone)), device="cpu")
    got = tt.solver_store.gather(everyone)
    _assert_close(got, want, 1e-5)
    # every client sampled so far carries nonzero slots into later rounds
    seen = sorted({i for ids in ct for i in ids})
    assert all(float(got["m/x"][i].abs().max()) > 0 for i in seen)
    if solver == "adam":
        assert [int(got["t"][i]) for i in everyone] == [
            K * sum(i in ids for ids in ct) for i in everyone]


@pytest.fixture(scope="module")
def lm_weights():
    cfg = jax_get_reduced("llama3.2-3b")
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))


def test_reduced_lm_momentum_fused(lm_weights):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05,
              local_solver="momentum", local_momentum=0.9,
              strategy="client_sequential")
    jcfg, tcfg = jax_get_reduced("llama3.2-3b"), get_reduced("llama3.2-3b")
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, lm_weights),
                  JSpec(**kw), JLM(4, jcfg.vocab_size, 32), seed=0,
                  use_fused_update=True)
    tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                          lambda gen: params_from_jax(lm_weights,
                                                      device="cpu"),
                          TSpec(**kw),
                          SyntheticLMFederated(4, tcfg.vocab_size, 32),
                          seed=0, use_fused_update=True, device="cpu")
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    for _ in range(2):
        mj, mt = jt.run_round(), tt.run_round()
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
    assert cj == ct
    server = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    everyone = np.arange(4)
    rows = state_from_jax(jax.tree.map(np.asarray, jt.store.gather(everyone)),
                          device="cpu")
    slots = state_from_jax(jax.tree.map(
        np.asarray, jt.solver_store.gather(everyone)), device="cpu")
    for want, got in ((server.x, tt.x), (server.c, tt.c),
                      (rows, tt.store.gather(everyone)),
                      (slots, tt.solver_store.gather(everyone))):
        _assert_close(got, want, 1e-4)


@pytest.mark.parametrize("slots_in", ["given", "fresh"])
def test_run_round_writes_client_rows_in_place(slots_in):
    """``run_round`` writes each client's new c_i and slot rows over the
    rows it was given (the reference returns fresh rows): the returned
    rows are the input tensors, updated. With no slot rows given it makes
    them in c_i's placement. The values equal a round on copies."""
    from repro_torch.core import ClientRoundState, init_server_state
    from repro_torch.core import make_grad_fn, run_round

    spec = TSpec(algorithm="scaffold", num_clients=N, num_sampled=S,
                 local_steps=K, local_batch=1, eta_l=0.05,
                 local_solver="momentum", local_momentum=0.9,
                 strategy="client_sequential")
    ds = make_similarity_quadratics(N, D, delta=0.3, G=2.0, mu=0.3)
    ids = np.arange(S)
    gen = torch.Generator().manual_seed(3)
    x = {"x": torch.randn(D, generator=gen)}
    server = init_server_state(spec, x)
    server.c = {"x": torch.randn(D, generator=gen)}
    c_i = {"x": torch.randn(S, D, generator=gen)}
    slots = ({"m/x": torch.randn(S, D, generator=gen)}
             if slots_in == "given" else None)
    batches = ds.round_batches(ids, K, 1, None, device="cpu")
    grad_fn = make_grad_fn(quadratic_loss)

    def copies(tree):
        return None if tree is None else {k: v.clone()
                                          for k, v in tree.items()}

    want = run_round(grad_fn, spec, server,
                     ClientRoundState(c_i=copies(c_i),
                                      solver_slots=copies(slots)), batches)
    before = copies(c_i)
    out = run_round(grad_fn, spec, server,
                    ClientRoundState(c_i=c_i, solver_slots=slots), batches)
    assert out.clients.c_i["x"] is c_i["x"]
    assert not torch.equal(c_i["x"], before["x"])
    assert torch.equal(out.clients.c_i["x"], want.clients.c_i["x"])
    got_m = out.clients.solver_slots["m/x"]
    if slots_in == "given":
        assert got_m is slots["m/x"]
    else:  # every client starts from solver.init: zero slots
        zeros = run_round(grad_fn, spec, server,
                          ClientRoundState(c_i=copies(before),
                                           solver_slots={"m/x": torch.zeros(
                                               S, D)}), batches)
        assert torch.equal(got_m, zeros.clients.solver_slots["m/x"])
    assert got_m.shape == (S, D) and got_m.device == c_i["x"].device
    assert torch.equal(got_m, want.clients.solver_slots["m/x"])
    assert bool((got_m.abs().amax(1) > 0).all())
