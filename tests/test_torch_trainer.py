"""The slice as a whole: the port's ``FederatedTrainer`` against the JAX
package's, on the same seeds, data and initial weights.

  * quickstart fig3 (G=10, K=10, fedavg and scaffold, 50 rounds): the x
    trajectory to 1e-5 of the starting point's scale (x converges to 0,
    so a relative bound at the end would be on fp32 noise), and the
    suboptimality to rtol 1e-5 (atol 1e-5 of its start, likewise);
  * quadratics N=20, d=64 with the K-step kernel path on (the JAX side
    under ``force_interpret()``): the same cohorts, x to rtol 1e-5 and
    the same ``megakernel_fallback_reason``;
  * the reduced LM, scaffold through the fused update, N=4, S=2, K=2,
    seq 32, 3 rounds (and N=3 with size-weighted aggregation): the same
    cohorts, x, c and the client store per leaf to rel 1e-4, and
    ``bytes_up`` / ``bytes_down`` equal.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.core import tree as JT
from repro.data import SyntheticLMFederated as JLM
from repro.data import make_paper_fig3 as jax_fig3
from repro.data import make_similarity_quadratics as jax_sim
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.kernels.scaffold_update.ops import force_interpret
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import tree as T
from repro_torch.core import FederatedTrainer
from repro_torch.data import SyntheticLMFederated, make_paper_fig3
from repro_torch.data import make_similarity_quadratics, quadratic_loss
from repro_torch.models import model as TM


def _record_cohorts(trainer):
    """Wrap the trainer's sampler so every drawn cohort is recorded."""
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def _pair_fig3(algo, **extra):
    kw = dict(algorithm=algo, num_clients=2, num_sampled=2, local_steps=10,
              local_batch=1, eta_l=0.1, eta_g=1.0, **extra)
    jds, tds = jax_fig3(G=10.0), make_paper_fig3(G=10.0)
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((jds.dim,), jnp.float32)},
                  JSpec(**kw), jds)
    tt = FederatedTrainer(quadratic_loss,
                          lambda gen: {"x": torch.ones(tds.dim)},
                          TSpec(**kw), tds, device="cpu")
    return jds, tds, jt, tt


@pytest.mark.parametrize("algo", ["fedavg", "scaffold"])
@pytest.mark.parametrize("strategy", ["client_parallel", "client_sequential"])
def test_quickstart_fig3_trajectory(algo, strategy):
    jds, tds, jt, tt = _pair_fig3(algo, strategy=strategy)
    x0 = 1.0  # the start is ones(d)
    f0 = jds.suboptimality(jt.x)
    for _ in range(50):
        mj, mt = jt.run_round(), tt.run_round()
        xj, xt = np.asarray(jt.x["x"]), tt.x["x"].numpy()
        assert np.abs(xj - xt).max() <= 1e-5 * max(x0, np.abs(xj).max())
        sj, st = jds.suboptimality(jt.x), tds.suboptimality(tt.x)
        assert abs(sj - st) <= 1e-5 * abs(sj) + 1e-5 * f0
        assert mt["bytes_up"] == mj["bytes_up"]
        assert mt["bytes_down"] == mj["bytes_down"]


@pytest.mark.parametrize("algo,extra", [
    ("scaffold", {"scaffold_option": "I"}),
    ("sgd", {}),
])
def test_fig3_other_paths(algo, extra):
    """Option I's extra gradient pass and the whole-batch sgd baseline."""
    _, _, jt, tt = _pair_fig3(algo, **extra)
    for _ in range(10):
        mj, mt = jt.run_round(), tt.run_round()
    xj = np.asarray(jt.x["x"])
    assert np.abs(xj - tt.x["x"].numpy()).max() <= 1e-5 * max(
        1.0, np.abs(xj).max())
    assert abs(mt["loss"] - mj["loss"]) <= 1e-5 * max(1.0, abs(mj["loss"]))


def test_quadratics_megakernel_path():
    jds = jax_sim(20, 64, delta=0.3, G=8.0, mu=0.3)
    tds = make_similarity_quadratics(20, 64, delta=0.3, G=8.0, mu=0.3)
    np.testing.assert_array_equal(jds.A, tds.A)
    kw = dict(algorithm="scaffold", num_clients=20, num_sampled=4,
              local_steps=10, local_batch=1, eta_l=0.1, use_megakernel=True)
    with force_interpret():
        jt = JTrainer(jax_quadratic_loss,
                      lambda key: {"x": jnp.ones((64,), jnp.float32)},
                      JSpec(**kw), jds, seed=3, use_fused_update=True)
        tt = FederatedTrainer(quadratic_loss,
                              lambda gen: {"x": torch.ones(64)}, TSpec(**kw),
                              tds, seed=3, use_fused_update=True,
                              device="cpu")
        cj, ct = _record_cohorts(jt), _record_cohorts(tt)
        for _ in range(5):
            mj, mt = jt.run_round(), tt.run_round()
            assert mt["megakernel_fallback_reason"] == \
                mj["megakernel_fallback_reason"] == ""
    assert cj == ct
    xj = np.asarray(jt.x["x"])
    assert np.abs(tt.x["x"].numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    assert tt.megakernel_fallback_reason == jt.megakernel_fallback_reason


@pytest.fixture(scope="module")
def lm_weights():
    cfg = jax_get_reduced("llama3.2-3b")
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))


@pytest.mark.parametrize("strategy,n_clients,weighted", [
    ("client_parallel", 4, False),
    ("client_sequential", 4, False),
    # 3 clients split the 512-token vocabulary unevenly: unequal weights
    ("client_parallel", 3, True),
    ("client_sequential", 3, True),
])
def test_reduced_lm_scaffold_fused(lm_weights, strategy, n_clients,
                                   weighted):
    kw = dict(algorithm="scaffold", num_clients=n_clients, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05, strategy=strategy,
              weighted_aggregation=weighted)
    jcfg, tcfg = jax_get_reduced("llama3.2-3b"), get_reduced("llama3.2-3b")
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, lm_weights),
                  JSpec(**kw), JLM(n_clients, jcfg.vocab_size, 32), seed=0,
                  use_fused_update=True)
    tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                          lambda gen: params_from_jax(lm_weights,
                                                      device="cpu"),
                          TSpec(**kw), SyntheticLMFederated(
                              n_clients, tcfg.vocab_size, 32), seed=0,
                          use_fused_update=True, device="cpu")
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    for _ in range(3):
        mj, mt = jt.run_round(), tt.run_round()
        assert mt["bytes_up"] == mj["bytes_up"]
        assert mt["bytes_down"] == mj["bytes_down"]
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
    assert cj == ct
    server = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    everyone = np.arange(n_clients)
    rows = state_from_jax(jax.tree.map(np.asarray, jt.store.gather(everyone)),
                          device="cpu")
    for want, got in ((server.x, tt.x), (server.c, tt.c),
                      (rows, tt.store.gather(everyone))):
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert ((got[k] - v).abs().max()
                    <= 1e-4 * max(float(v.abs().max()), 1e-30)), k


def test_lm_megakernel_falls_back_loudly(lm_weights):
    tcfg = get_reduced("llama3.2-3b")
    spec = TSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                 local_steps=1, local_batch=1, use_megakernel=True)
    with pytest.warns(UserWarning, match="per-step path"):
        tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                              lambda gen: params_from_jax(lm_weights,
                                                          device="cpu"),
                              spec, SyntheticLMFederated(4, 512, 8),
                              device="cpu")
    m = tt.run_round()
    assert m["megakernel_fallback_reason"] == (
        "grad not kernel-expressible (loss_fn lacks "
        "megakernel_grad='quadratic')")


@pytest.mark.parametrize("change", [
    # the pipelined engine, the tiered store and its backends are ported
    # (tests/test_torch_store.py, test_torch_tiered.py,
    # test_torch_pipelined.py); the async engine is not
    dict(trainer={"async_buffer": 2}),
])
def test_not_ported_modes_raise(change):
    tds = make_paper_fig3()
    spec = dataclasses.replace(
        TSpec(algorithm="scaffold", num_clients=2, num_sampled=2,
              local_steps=1, local_batch=1), **change.get("spec", {}))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(20)},
                         spec, tds, device="cpu", **change.get("trainer", {}))


@pytest.mark.parametrize("change", [
    {"algorithm": "fedprox"},
    {"algorithm": "scaffold_m"},
    {"server_optimizer": "adam"},
    {"local_solver": "momentum"},
    {"compress": "int8_ef"},
], ids=["fedprox", "scaffold_m", "server_adam", "local_momentum",
        "int8_uplink"])
def test_ported_modes_match_reference(change):
    """Modes that once raised "not ported yet" construct on the CPU and
    run one round equal to the reference's (x to 1e-5 of the start's
    scale, 1)."""
    kw = {**dict(algorithm="scaffold", num_clients=2, num_sampled=2,
                 local_steps=1, local_batch=1), **change}
    jds, tds = jax_fig3(), make_paper_fig3()
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((jds.dim,), jnp.float32)},
                  JSpec(**kw), jds)
    tt = FederatedTrainer(quadratic_loss,
                          lambda gen: {"x": torch.ones(tds.dim)},
                          TSpec(**kw), tds, device="cpu")
    mj, mt = jt.run_round(), tt.run_round()
    xj = np.asarray(jt.x["x"])
    assert np.abs(tt.x["x"].numpy() - xj).max() <= 1e-5 * max(
        1.0, np.abs(xj).max())
    assert abs(mt["loss"] - mj["loss"]) <= 1e-5 * max(1.0, abs(mj["loss"]))


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = {"p": rng.standard_normal((3, 4)).astype(np.float32),
         "q": rng.standard_normal(5).astype(np.float32)}
    b = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in a.items()}
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    ta, tb = ({k: torch.from_numpy(v) for k, v in t.items()} for t in (a, b))
    for jv, tv in ((JT.tree_add(ja, jb), T.tree_add(ta, tb)),
                   (JT.tree_sub(ja, jb), T.tree_sub(ta, tb)),
                   (JT.tree_scale(ja, 0.3), T.tree_scale(ta, 0.3))):
        for k in a:
            np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]),
                                       rtol=1e-6)
    np.testing.assert_allclose(float(T.tree_norm(ta)),
                               float(JT.tree_norm(ja)), rtol=1e-6)
    store = {k: np.stack([v, 2 * v, 3 * v]) for k, v in a.items()}
    ids = np.array([2, 0])
    jg = JT.tree_gather(jax.tree.map(jnp.asarray, store), ids)
    ts = {k: torch.from_numpy(v.copy()) for k, v in store.items()}
    tg = T.tree_gather(ts, ids)
    new = {k: -v for k, v in tg.items()}
    js = JT.tree_scatter(jax.tree.map(jnp.asarray, store), ids,
                         jax.tree.map(lambda v: -v, jg))
    T.tree_scatter(ts, ids, new)
    for k in a:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
