"""The paper's EMNIST experiment in the port against the JAX package, on
the CPU, from the same numpy seeds and the same weights.

  * the data: ``generate_dataset``, ``similarity_split``,
    ``round_batches`` (one ``default_rng`` stream drawn by both),
    ``client_sizes``, ``local_batch_size`` and ``test_batch``: bitwise;
  * the models: logreg and MLP losses, logits and gradients (the port's
    autograd against ``jax.grad``) within 1e-6 relative; ``accuracy``
    equal;
  * ``FederatedTrainer``, 3 rounds on a small split (N 10, 2,000
    samples, S 4, K 5, similarity 0 and 10): SGD, FedAvg, FedProx and
    SCAFFOLD (through the fused update), each on logreg and the MLP at
    both splits, weighted and unweighted under both client strategies
    (the four pairs rotate through each algorithm's runs), against the
    reference's host loop: the same cohorts, x within 1e-5 relative after
    round 1 and 1e-4 after round 3 (each element, relative to its leaf's
    largest), the bytes exact; the MLP may part in at most one hidden
    unit, and only at a relu kink shown in the reference (``_check_x``);
    a wrong step (eta_l off by 1 %, a dropped correction) fails that
    check. 2,000 samples split evenly over 10 clients, so the weighted
    cases draw from 2,007 samples, whose shards hold 200 or 201 (unequal
    weights);
  * ``use_megakernel=True`` reports the reference's fallback reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import emnist_like as J
from repro.models import simple as JS
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import params_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.data import emnist_like as T
from repro_torch.models import simple as TS

N, SAMPLES, UNEVEN, S, K = 10, 2000, 2007, 4, 5


def _pair(sim, samples=SAMPLES):
    kw = dict(num_clients=N, samples=samples, similarity_pct=sim, seed=0)
    return J.EmnistLikeFederated(**kw), T.EmnistLikeFederated(**kw)


@pytest.fixture(scope="module")
def data():
    pairs = {sim: _pair(sim) for sim in (0.0, 10.0)}
    pairs.update({(sim, UNEVEN): _pair(sim, UNEVEN) for sim in (0.0, 10.0)})
    return pairs


@pytest.fixture(scope="module")
def weights():
    key = jax.random.key(7)
    mlp = jax.tree.map(np.asarray, JS.mlp_init(key, T.IMG_DIM, 62))
    rng = np.random.default_rng(3)
    logreg = {"w": (0.05 * rng.standard_normal((T.IMG_DIM, 62))
                    ).astype(np.float32),
              "b": (0.1 * rng.standard_normal(62)).astype(np.float32)}
    return {"mlp": mlp, "logreg": logreg}


MODELS = {
    "logreg": ((JS.logreg_loss, JS.logreg_logits),
               (TS.logreg_loss, TS.logreg_logits)),
    "mlp": ((JS.mlp_loss, JS.mlp_logits), (TS.mlp_loss, TS.mlp_logits)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("sim", [0.0, 10.0, 37.5])
def test_generate_and_split_bitwise(sim):
    xj, yj = J.generate_dataset(500, seed=4)
    xt, yt = T.generate_dataset(500, seed=4)
    np.testing.assert_array_equal(xj, xt)
    np.testing.assert_array_equal(yj, yt)
    assert xt.dtype == np.float32 and yt.dtype == np.int32
    sj = J.similarity_split(yj, 7, sim, seed=2)
    st = T.similarity_split(yt, 7, sim, seed=2)
    assert len(sj) == len(st) == 7
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sim", [0.0, 10.0])
def test_dataset_views_bitwise(data, sim):
    jd, td = data[sim]
    for a, b in ((jd.x, td.x), (jd.y, td.y), (jd.tx, td.tx), (jd.ty, td.ty)):
        np.testing.assert_array_equal(a, b)
    ids = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(jd.client_sizes(ids), td.client_sizes(ids))
    assert td.client_sizes(ids).dtype == np.int64
    uneven = data[(sim, UNEVEN)][1].client_sizes(np.arange(N))
    assert sorted(set(uneven.tolist())) == [200, 201]
    for frac in (0.2, 0.05, 1.0):
        assert jd.local_batch_size(frac) == td.local_batch_size(frac)
    jt, tt = jd.test_batch(), td.test_batch(device="cpu")
    for k in ("x", "y"):
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy())


@pytest.mark.parametrize("sim", [0.0, 10.0])
@pytest.mark.parametrize("kb", [(5, 40), (3, 250)],
                         ids=["without_replacement", "with_replacement"])
def test_round_batches_bitwise(data, sim, kb):
    """Both packages consume one numpy stream in the same order; a
    second round from the same stream still agrees."""
    jd, td = data[sim]
    k, b = kb
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for ids in (np.array([4, 1, 7, 2]), np.array([0, 9])):
        bj = jd.round_batches(ids, k, b, rj)
        bt = td.round_batches(ids, k, b, rt, device="cpu")
        assert bt["x"].shape == (len(ids), k, b, T.IMG_DIM)
        assert bt["y"].dtype == torch.int32
        for key in ("x", "y"):
            np.testing.assert_array_equal(np.asarray(bj[key]),
                                          bt[key].numpy())
    assert rj.random() == rt.random()


def _batch(data, n=96):
    jd, _ = data[10.0]
    x, y = jd.x[:n], jd.y[:n]
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x.copy()), "y": torch.from_numpy(y.copy())})


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_loss_logits_grads_match(data, weights, model):
    (jloss, jlogits), (tloss, tlogits) = MODELS[model]
    jb, tb = _batch(data)
    jp = jax.tree.map(jnp.asarray, weights[model])
    tp = params_from_jax(weights[model], device="cpu")
    assert sorted(tp) == sorted(weights[model])
    assert _rel(tlogits(tp, tb).numpy(), jlogits(jp, jb)) <= 1e-6
    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(jp, jb)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    lt, mt = tloss(leaves, tb)
    gt = dict(zip(leaves, torch.autograd.grad(lt, list(leaves.values()))))
    assert abs(lt.item() - float(lj)) <= 1e-6 * abs(float(lj))
    assert mt["loss"].item() == lt.item()
    for k in tp:
        assert _rel(gt[k].numpy(), gj[k]) <= 1e-6, k


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_accuracy_equal(data, weights, model):
    (_, jlogits), (_, tlogits) = MODELS[model]
    jd, td = data[0.0]
    jp = jax.tree.map(jnp.asarray, weights[model])
    tp = params_from_jax(weights[model], device="cpu")
    assert (TS.accuracy(tlogits, tp, td.test_batch(device="cpu"))
            == JS.accuracy(jlogits, jp, jd.test_batch()))


def test_port_init_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = TS.mlp_init(gen, T.IMG_DIM, 62, device="cpu")
    jp = JS.mlp_init(jax.random.key(0), T.IMG_DIM, 62)
    assert list(p) == sorted(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32
    assert abs(float(p["w1"].std()) - float(jnp.std(jp["w1"]))) < 2e-3
    assert not p["b1"].any() and not p["b2"].any()
    lr = TS.logreg_init(gen, T.IMG_DIM, 62, device="cpu")
    jl = JS.logreg_init(None, T.IMG_DIM, 62)
    assert {k: tuple(v.shape) for k, v in lr.items()} == {
        k: v.shape for k, v in jl.items()}
    assert not any(v.any() for v in lr.values())


def _record_cohorts(trainer):
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def _trainers(data, weights, model, sim, **kw):
    jd, td = data[(sim, UNEVEN) if kw.get("weighted_aggregation") else sim]
    b = jd.local_batch_size(0.2)
    base = dict(num_clients=N, num_sampled=S, local_batch=b, eta_l=0.3,
                fedprox_mu=1.0)
    base.update(kw)
    jloss = MODELS[model][0][0]
    tloss = MODELS[model][1][0]
    w = weights[model]
    jt = JTrainer(jloss, lambda key: jax.tree.map(jnp.asarray, w),
                  JSpec(**base), jd, seed=0, use_fused_update=True)
    tt = FederatedTrainer(tloss, lambda gen: params_from_jax(w, device="cpu"),
                          TSpec(**base), td, seed=0, use_fused_update=True,
                          device="cpu")
    return jt, tt


# The relu kink: the two packages sum a hidden unit's pre-activation in
# different orders, ~1e-6 of its scale apart, so a sample whose
# pre-activation lies that close to 0 may take the relu's other branch on
# one side, and the unit's w1 column and b1 entry part. sgd-mlp-10.0
# parts so in round 2 on some machines (b1[96] 4.4e-3 relative, 362
# elements of w1[:, 96] up to 5.0e-4; w2 and b2 within 1.6e-7): a sample's
# pre-activation of unit 96 at the round's start lies at 3.0e-8 of the
# unit's largest over the round's batch, the next unit's nearest at
# 4.6e-6. A kink counts when some sample of the round's batch has a
# pre-activation, at the reference's x at the round's start (the point of
# the first local step's gradient), within KINK_EPS of the unit's largest
# |pre-activation| over that batch.
KINK_EPS = 1e-6


def _check_x(jt, tt, r, x0, batch, model, flipped):
    """x after round r (0-based) within 1e-5 of each leaf's largest
    element after round 0 and 1e-4 after, every element; the MLP may part
    in one hidden unit (``flipped``, a set carried across rounds), its w1
    column and b1 entry, where the round at which it parts shows a relu
    kink: ``x0`` is the reference's x at the round's start and ``batch``
    the round's ``round_batches``."""
    bound = 1e-5 if r == 0 else 1e-4
    apart = set()
    for k, v in jt.x.items():
        want = np.asarray(v, np.float64)
        err = np.abs(tt.x[k].numpy() - want) / max(np.abs(want).max(), 1e-30)
        idx = np.argwhere(err > bound)
        if len(idx):
            assert model == "mlp" and k in ("w1", "b1"), (r, k, err.max())
            apart.update(idx[:, -1].tolist())
    new = apart - flipped
    assert len(apart) <= 1, (r, sorted(apart))
    for u in new:
        xs = np.asarray(batch["x"], np.float64).reshape(-1, T.IMG_DIM)
        pre = np.abs(xs @ x0["w1"][:, u] + x0["b1"][u])
        assert pre.min() <= KINK_EPS * pre.max(), (r, u, pre.min() /
                                                   pre.max())
    flipped |= new


def _run_rounds(jt, tt, model, monkeypatch, rounds=3, metrics=True):
    """``rounds`` rounds of both trainers, x held by ``_check_x`` after
    each (and the bytes and the loss when ``metrics``)."""
    batches = []
    draw = jt.dataset.round_batches

    def recording(*a, **kw):
        batches.append(draw(*a, **kw))
        return batches[-1]

    monkeypatch.setattr(jt.dataset, "round_batches", recording)
    flipped = set()
    for r in range(rounds):
        x0 = {k: np.asarray(v, np.float64) for k, v in jt.x.items()}
        mj, mt = jt.run_round(), tt.run_round()
        if metrics:
            assert mt["bytes_up"] == mj["bytes_up"]
            assert mt["bytes_down"] == mj["bytes_down"]
            assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
        _check_x(jt, tt, r, x0, batches[-1], model, flipped)


# every algorithm on both models and both splits; the four (weighted,
# strategy) pairs rotate through each algorithm's four (model, split)
# runs, so each algorithm meets every pair once
PAIRS = [(False, "client_parallel"), (True, "client_sequential"),
         (True, "client_parallel"), (False, "client_sequential")]
TRAINER_CASES = [
    (algo, model, sim) + PAIRS[(a + 2 * m + s) % 4]
    for a, algo in enumerate(("fedavg", "fedprox", "scaffold"))
    for m, model in enumerate(("logreg", "mlp"))
    for s, sim in enumerate((0.0, 10.0))
] + [("sgd", model, sim, False, "client_parallel")
     for model in ("logreg", "mlp") for sim in (0.0, 10.0)]


@pytest.mark.parametrize("algo,model,sim,weighted,strategy", TRAINER_CASES)
def test_trainer_matches_reference_host_loop(data, weights, algo, model, sim,
                                             weighted, strategy,
                                             monkeypatch):
    jt, tt = _trainers(data, weights, model, sim, algorithm=algo,
                       local_steps=1 if algo == "sgd" else K,
                       weighted_aggregation=weighted, strategy=strategy)
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    _run_rounds(jt, tt, model, monkeypatch)
    assert cj == ct
    if algo == "scaffold":
        ids = np.arange(N)
        rows = jt.store.gather(ids)
        got = tt.store.gather(ids)
        for k, v in rows.items():
            assert _rel(got[k].numpy(), v) <= 1e-4, k


# a wrong step on the port's side: (algorithm, model, split, the port's
# spec changes)
WRONG_STEPS = {
    "eta_l off by 1 %": ("sgd", "mlp", 10.0, dict(eta_l=0.3 * 1.01)),
    "correction dropped": ("scaffold", "mlp", 0.0,
                           dict(algorithm="fedavg")),
}


@pytest.mark.parametrize("wrong", sorted(WRONG_STEPS))
def test_x_check_fails_on_a_wrong_step(data, weights, monkeypatch, wrong):
    """The check that admits one kinked unit still fails a wrong step:
    the port's trainer with eta_l 1 % off, or with SCAFFOLD's correction
    dropped (FedAvg), against the reference's right one."""
    algo, model, sim, port = WRONG_STEPS[wrong]
    jt, _ = _trainers(data, weights, model, sim, algorithm=algo,
                      local_steps=1 if algo == "sgd" else K)
    _, tt = _trainers(data, weights, model, sim, local_steps=1 if algo ==
                      "sgd" else K, **{"algorithm": algo, **port})
    with pytest.raises(AssertionError):
        _run_rounds(jt, tt, model, monkeypatch, metrics=False)


def test_megakernel_reports_the_reference_reason(data, weights):
    with pytest.warns(UserWarning, match="per-step path"):
        jt, tt = _trainers(data, weights, "mlp", 0.0, algorithm="scaffold",
                           local_steps=K, use_megakernel=True)
    mj, mt = jt.run_round(), tt.run_round()
    assert mt["megakernel_fallback_reason"] == mj[
        "megakernel_fallback_reason"] == (
        "grad not kernel-expressible (loss_fn lacks "
        "megakernel_grad='quadratic')")
