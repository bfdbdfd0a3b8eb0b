"""The port's update spaces against the JAX package's, on the CPU.

  * ``leaf_paths``: the escaped paths, in the reference's order;
  * ``init_deltas``: keys (``convert.flatten_tree`` of the reference's
    delta tree), shapes, dtypes, and values, the LoRA ``A`` draws
    injected from the reference's fold path ``key(4)`` folded by the
    target (``streams.injected``): bitwise;
  * ``apply`` and ``grad_project`` for ``lora`` (A injected, B nonzero)
    and ``head_only``, on the reduced llama and gemma3 and on the EMNIST
    MLP: within 1e-5 of each leaf's largest element in fp32 (the MLP),
    1e-4 for the LMs; the closed form equals autograd through ``apply``;
  * the delta-space gradient of ``make_grad_fn(space=...)`` against the
    reference's, on the MLP (the LMs' through the trainer rounds);
  * ``FederatedTrainer`` rounds of ``lora`` (sgd and local heavy-ball)
    and ``head_only`` against the reference's host loop
    (``pipeline_depth=0``, ``scan_rounds=0``): the same cohorts,
    ``bytes_up``/``bytes_down`` equal as integers, and ``x``, ``c``, every
    client's ``c_i`` and slot rows and ``eval_params()`` within the
    tolerances above (c and c_i against x's scale, see
    ``assert_trainers_agree``);
  * ``use_megakernel`` under a subset space reports the reference's
    fallback reason;
  * ``full`` keeps the unwrapped grad fn and adds no ``update_space``
    metric.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.core import update_space as JU
from repro.core.controller import make_grad_fn as jax_make_grad_fn
from repro.data import SyntheticLMFederated as JLM
from repro.data import emnist_like as JE
from repro.data import make_paper_fig3 as jax_fig3
from repro.data.quadratics import quadratic_loss as jax_quadratic_loss
from repro.models import model as JM
from repro.models import simple as JS
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree, params_from_jax, state_from_jax
from repro_torch.core import FederatedTrainer, streams
from repro_torch.core import update_space as TU
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import SyntheticLMFederated, make_paper_fig3
from repro_torch.data import emnist_like as TE
from repro_torch.data import quadratic_loss
from repro_torch.models import model as TM
from repro_torch.models import simple as TS

# (update_space, lora_rank, lora_alpha, update_targets) by model
SPACES = {
    "mlp": {"lora": ("lora", 4, 8.0, "w1,w2"),
            "head_only": ("head_only", 0, 0.0, "w2,b2")},
    "llama3.2-3b": {"lora": ("lora", 4, 8.0, ""),
                    "head_only": ("head_only", 0, 0.0, "embed,ln_final*")},
    "gemma3-1b": {"lora": ("lora", 4, 0.0, ""),
                  "head_only": ("head_only", 0, 0.0, "ln_final*,embed")},
}
# a leaf's bound, relative to its largest element
TOL = {"mlp": 1e-5, "llama3.2-3b": 1e-4, "gemma3-1b": 1e-4}


def _space_kw(model, space):
    name, rank, alpha, targets = SPACES[model][space]
    return dict(update_space=name, lora_rank=rank, lora_alpha=alpha,
                update_targets=targets)


def jax_key(path):
    """The reference's key at a fold path: key(base) folded by the rest."""
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    return k


@functools.lru_cache(maxsize=None)
def _jax_normal(path, shape):
    return np.asarray(jax.random.normal(jax_key(path), shape, jnp.float32))


def jax_draws(kind, path, shape):
    """The reference's normal draw at ``path`` (``streams.injected``)."""
    assert kind == "normal", kind
    return _jax_normal(tuple(path), tuple(shape))


@pytest.fixture(scope="module")
def weights():
    out = {"mlp": jax.tree.map(np.asarray,
                               JS.mlp_init(jax.random.key(7), TE.IMG_DIM, 62))}
    for arch in ("llama3.2-3b", "gemma3-1b"):
        out[arch] = jax.tree.map(np.asarray, JM.init_params(
            jax_get_reduced(arch), jax.random.key(0)))
    return out


def _close(got: torch.Tensor, want, tol, what="", floor=1e-30):
    """Within ``tol`` of the larger of want's largest element and
    ``floor``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= bound, what


def _trees_close(got, want_tree, tol):
    want = flatten_tree(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, tol, k)


def _deltas_pair(weights, model, space, seed=1):
    """The reference's and the port's round-0 deltas, the LoRA B factors
    (and head_only leaves) then moved off their init by one numpy draw."""
    kw = _space_kw(model, space)
    jspec, tspec = JSpec(**_base_spec(), **kw), TSpec(**_base_spec(), **kw)
    jsp, tsp = JU.get_update_space(kw["update_space"]), TU.get_update_space(
        kw["update_space"])
    jbase = jax.tree.map(jnp.asarray, weights[model])
    tbase = params_from_jax(weights[model], device="cpu")
    jd = jsp.init_deltas(jspec, jbase, jax.random.key(4))
    with streams.injected(jax_draws):
        td = tsp.init_deltas(tspec, tbase, streams.stream_key(4, "cpu"))
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, jd))
    moved = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                 if space == "head_only" or k.endswith("/B") else v)
             for k, v in flat.items()}
    jd_moved = jax.tree.map(jnp.asarray, _nest(moved))
    td_moved = {k: torch.from_numpy(moved[k].copy()) for k in td}
    return (jsp, jspec, jbase, jd, jd_moved), (tsp, tspec, tbase, td,
                                                td_moved)


def _nest(flat):
    """A flat delta tree back to the reference's ``{path: {A, B}}``."""
    out = {}
    for k, v in flat.items():
        path, sep, fac = k.partition("/")
        if sep:
            out.setdefault(path, {})[fac] = v
        else:
            out[path] = v
    return out


def _base_spec():
    return dict(algorithm="scaffold", num_clients=4, num_sampled=2,
                local_steps=2, local_batch=1)


MODELS = ("mlp", "llama3.2-3b", "gemma3-1b")


@pytest.mark.parametrize("model", MODELS)
def test_leaf_paths_match(weights, model):
    tbase = params_from_jax(weights[model], device="cpu")
    want = [p for p, _ in JU.leaf_paths(weights[model])]
    assert [p for p, _ in TU.leaf_paths(tbase)] == want


@pytest.mark.parametrize("space", ["lora", "head_only"])
@pytest.mark.parametrize("model", MODELS)
def test_init_deltas_bitwise(weights, model, space):
    (jsp, jspec, jbase, jd, _), (tsp, tspec, tbase, td, _) = _deltas_pair(
        weights, model, space)
    want = flatten_tree(jax.tree.map(np.asarray, jd))
    assert list(td) == sorted(want, key=lambda k: tuple(k.split("/")))
    for k, v in want.items():
        assert td[k].dtype == torch.float32 and v.dtype == np.float32, k
        np.testing.assert_array_equal(td[k].numpy(), v, err_msg=k)
    if space == "lora":
        assert not any(td[k].any() for k in td if k.endswith("/B"))
        n_targets = len(td) // 2
        assert n_targets == (2 if model == "mlp" else
                             7 * len({k.split(".")[1] for k in td}))
    # apply at the init is the base itself
    merged = tsp.apply(tspec, tbase, td)
    for k, v in tbase.items():
        assert torch.equal(merged[k], v), k


@pytest.mark.parametrize("space", ["lora", "head_only"])
@pytest.mark.parametrize("model", MODELS)
def test_apply_and_grad_project_match(weights, model, space):
    (jsp, jspec, jbase, _, jd), (tsp, tspec, tbase, _, td) = _deltas_pair(
        weights, model, space)
    tol = TOL[model]
    _trees_close(tsp.apply(tspec, tbase, td), jsp.apply(jspec, jbase, jd),
                 tol)
    rng = np.random.default_rng(2)
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in flatten_tree(weights[model]).items()}
    jg = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(g["/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)]),
        weights[model])
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    got = tsp.grad_project(tspec, tbase, td, tg)
    _trees_close(got, jsp.grad_project(jspec, jbase, jd, jg), tol)
    # the closed form is the chain rule: autograd through apply agrees
    keys = tsp.grad_keys(tspec, tbase, td)
    generic = TU.UpdateSpace.grad_project(tsp, tspec, tbase, td,
                                          {k: tg[k] for k in keys})
    for k, v in got.items():
        assert torch.allclose(generic[k], v, rtol=1e-5, atol=1e-6), k


def _loss_pair(model):
    if model == "mlp":
        return JS.mlp_loss, TS.mlp_loss
    jcfg, tcfg = jax_get_reduced(model), get_reduced(model)
    return partial(JM.loss_fn, jcfg), partial(TM.loss_fn, tcfg)


def _batch_pair(model):
    rng = np.random.default_rng(3)
    if model == "mlp":
        x = rng.standard_normal((16, TE.IMG_DIM)).astype(np.float32)
        y = rng.integers(0, 62, 16).astype(np.int32)
        return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
                {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    toks = rng.integers(0, 512, size=(2, 33)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("model", ["mlp"])
def test_delta_space_grad_matches_reference(weights, model):
    (jsp, jspec, jbase, _, jd), (tsp, tspec, tbase, _, td) = _deltas_pair(
        weights, model, "lora")
    jloss, tloss = _loss_pair(model)
    jb, tb = _batch_pair(model)
    jg, jm = jax_make_grad_fn(jloss, space=jsp, spec=jspec,
                              base_params=jbase)(jd, jb)
    fn = make_grad_fn(tloss, space=tsp, spec=tspec, base_params=tbase)
    assert fn.megakernel_grad is None
    tg, tm = fn(td, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    _trees_close(tg, jg, TOL[model])
    # the base is frozen: nothing was written into it
    for k, v in params_from_jax(weights[model], device="cpu").items():
        assert torch.equal(tbase[k], v), k


# -- trainer rounds ----------------------------------------------------------

N_CLIENTS, EMNIST_SAMPLES = 6, 1200


@pytest.fixture(scope="module")
def emnist():
    kw = dict(num_clients=N_CLIENTS, samples=EMNIST_SAMPLES,
              similarity_pct=10.0, seed=0, test_samples=200)
    return JE.EmnistLikeFederated(**kw), TE.EmnistLikeFederated(**kw)


def _record_cohorts(trainer):
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def trainer_pair(weights, model, space, emnist=None, **extra):
    """The reference's and the port's trainers from the same weights,
    the LoRA init injected into the port's."""
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05)
    if model == "mlp":
        jd, td = emnist
        kw.update(num_clients=N_CLIENTS, num_sampled=3, local_steps=3,
                  local_batch=jd.local_batch_size(0.2), eta_l=0.3)
    else:
        vocab = get_reduced(model).vocab_size
        jd, td = (JLM(4, vocab, 32), SyntheticLMFederated(4, vocab, 32))
    kw.update(_space_kw(model, space), **extra)
    jloss, tloss = _loss_pair(model)
    w = weights[model]
    jt = JTrainer(jloss, lambda key: jax.tree.map(jnp.asarray, w),
                  JSpec(**kw), jd, seed=0, use_fused_update=True)
    with streams.injected(jax_draws):
        tt = FederatedTrainer(tloss,
                              lambda gen: params_from_jax(w, device="cpu"),
                              TSpec(**kw), td, seed=0, use_fused_update=True,
                              device="cpu")
    return jt, tt


def assert_trainers_agree(jt, tt, tol):
    """x, c, every client's c_i and slot rows, eval_params().

    Option II's control variates are ``(x - y_K) / (K eta_l)`` less c:
    their rounding error is set by x's magnitude, not theirs (a LoRA
    factor A moves ~1e-6 of itself in a round while B is small, so its
    c_i is a difference of two nearly equal fp32 numbers). A c or c_i
    leaf is held to ``tol`` of the larger of its own largest element and
    x's over ``K eta_l``: x's bound carried through the division."""
    spec = tt.spec
    want = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    assert sorted(tt.x) == sorted(want.x) == sorted(tt.c) == sorted(want.c)
    for k, v in want.x.items():
        _close(tt.x[k], v.numpy(), tol, k)
    x_scale = {k: float(v.abs().max()) / (spec.local_steps * spec.eta_l)
               for k, v in want.x.items()}
    for k, v in want.c.items():
        _close(tt.c[k], v.numpy(), tol, k, floor=x_scale[k])
    ids = np.arange(jt.store.num_clients)
    rows = flatten_tree(jax.tree.map(np.asarray, jt.store.gather(ids)))
    got = tt.store.gather(ids)
    assert sorted(got) == sorted(rows)
    for k, v in rows.items():
        _close(got[k], v, tol, k, floor=x_scale[k])
    if jt.solver_store is not None:
        _trees_close(tt.solver_store.gather(ids), jt.solver_store.gather(ids),
                     tol)
    _trees_close(tt.eval_params(), jt.eval_params(), tol)


ROUND_CASES = [("mlp", "lora", "sgd", 3), ("mlp", "head_only", "sgd", 3),
               ("mlp", "lora", "momentum", 3),
               ("llama3.2-3b", "lora", "sgd", 2),
               ("llama3.2-3b", "head_only", "sgd", 2)]


@pytest.mark.parametrize("model,space,solver,rounds", ROUND_CASES)
def test_trainer_rounds_match_reference(weights, emnist, model, space,
                                        solver, rounds):
    jt, tt = trainer_pair(weights, model, space, emnist, local_solver=solver)
    assert tt.update_space.name == jt.update_space.name == space
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    for _ in range(rounds):
        mj, mt = jt.run_round(), tt.run_round()
        assert mt["update_space"] == mj["update_space"] == space
        for k in ("bytes_up", "bytes_down"):
            assert int(mt[k]) == int(mj[k]) and mt[k] == mj[k], k
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
    assert cj == ct
    assert_trainers_agree(jt, tt, TOL[model])
    # the stores hold delta-shaped rows
    assert {k: tuple(v.shape[1:]) for k, v in tt.store.all_rows().items()} == {
        k: tuple(v.shape) for k, v in tt.x.items()}


def test_megakernel_reports_the_reference_reason_under_a_subset_space():
    kw = dict(algorithm="scaffold", num_clients=2, num_sampled=2,
              local_steps=4, local_batch=1, eta_l=0.1, use_megakernel=True,
              update_space="head_only", update_targets="x")
    jds, tds = jax_fig3(G=10.0), make_paper_fig3(G=10.0)
    with pytest.warns(UserWarning, match="per-step path"):
        jt = JTrainer(jax_quadratic_loss,
                      lambda key: {"x": jnp.ones((jds.dim,), jnp.float32)},
                      JSpec(**kw), jds)
    with pytest.warns(UserWarning, match="per-step path"):
        tt = FederatedTrainer(quadratic_loss,
                              lambda gen: {"x": torch.ones(tds.dim)},
                              TSpec(**kw), tds, device="cpu")
    mj, mt = jt.run_round(), tt.run_round()
    assert mt["megakernel_fallback_reason"] == mj[
        "megakernel_fallback_reason"] == (
        "grad not kernel-expressible (loss_fn lacks "
        "megakernel_grad='quadratic')")
    _close(tt.x["x"], np.asarray(jt.server.x["x"]), 1e-5)


def test_full_space_keeps_the_unwrapped_grad_fn():
    kw = dict(algorithm="scaffold", num_clients=2, num_sampled=2,
              local_steps=2, local_batch=1)
    tds = make_paper_fig3(G=10.0)
    tt = FederatedTrainer(quadratic_loss,
                          lambda gen: {"x": torch.ones(tds.dim)},
                          TSpec(**kw, update_space="full"), tds,
                          device="cpu")
    assert tt.base_params is None and tt.update_space.name == "full"
    assert tt._grad_fn.megakernel_grad == "quadratic"
    assert tt.eval_params() is tt.x
    assert "update_space" not in tt.run_round()


def test_spec_rejects_what_the_reference_rejects():
    for bad in (dict(update_space="lora"),
                dict(update_space="head_only"),
                dict(update_space="full", lora_rank=4),
                dict(update_space="nope")):
        with pytest.raises(AssertionError):
            JSpec(**_base_spec(), **bad)
        with pytest.raises(AssertionError):
            TSpec(**_base_spec(), **bad)
    assert TSpec(**_base_spec()).update_space == "full"
    assert TU.update_space_names() == tuple(JU.update_space_names())
