"""The port's async buffered engine (``repro_torch.core.async_engine``), on
the CPU: held to the port's own synchronous loop in its degenerate limit,
to the JAX package's async engine under stragglers, and to the
reference's behavioural contract.

  * degenerate limit, bitwise (``==`` on every array and on the sync
    metrics): M = K = S, ``always_on``, ``constant`` against
    ``FederatedTrainer(pipeline_depth=0)`` of the port, in the reference's
    8 cases ({scaffold, scaffold_m} x {none, int8_ef} x {sgd, adam}) and
    its EMNIST-loader case, and further through weighted aggregation,
    both privatizers, a downlink codec and the stateful local solvers;
  * against the reference's async engine under ``STRAGGLER`` (lognormal
    latency, sigma 1.5, 20 % dropout; M 3 of K 6) with constant,
    polynomial and cutoff weighting: the event stream (staleness
    histograms, dispatched, dropped, in flight, virtual time) and the
    bytes exactly; after 10 aggregations x, c and every row family within
    1e-5 of max|x|, on the quadratics (N 20, S 5, d 6) with and without
    int8_ef and on the reference's EMNIST logreg. int8_ef rounds to a
    grid, so an fp32 summation-order difference (~1e-7) can put an
    element on the other side of a step, one int8 step of one client
    apart: there (the codec tests' int8 allowance,
    tests/test_torch_compression.py, over 10 aggregations) at most 1
    element in 10,000 beyond 1e-5 of max|x| and none beyond 1e-2 of it,
    a row family measured against the larger of max|x| and its own
    largest element (the flip moves later clients' c_i rows, ~5x x's
    scale, by up to 6e-6 of their own);
  * keyed draws (randk_ef's permutations, distributed noise) with the
    reference's draws injected (``core.streams.injected``), to 1e-5;
  * the staleness weights within 1 fp32 ulp of the reference's;
  * the reference's behavioural tests: a dropped update never lands,
    weighting changes the trajectory, a zero cutoff freezes stale steps,
    scan, pipeline, whole-batch and client_sequential are refused, the
    observability fields, ``run()`` and history, tiered = dense under
    stragglers (dense and memmap backends).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.core import async_engine as JA
from repro.data import EmnistLikeFederated as JEmnist
from repro.data import make_similarity_quadratics as jax_quadratics
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.models.simple import logreg_init
from repro.models.simple import logreg_loss as jax_logreg_loss
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import params_from_jax
from repro_torch.core import FederatedTrainer, streams
from repro_torch.core import async_engine as TA
from repro_torch.core.availability import UniformLatency
from repro_torch.data import EmnistLikeFederated, make_similarity_quadratics
from repro_torch.data import quadratic_loss
from repro_torch.models.simple import logreg_loss

N, S, DIM = 20, 5, 6
STRAGGLER = dict(availability="lognormal",
                 availability_kwargs=dict(seed=1, sigma=1.5, dropout=0.2))
ASYNC_KW = dict(async_buffer=3, max_inflight=6,
                staleness_weighting="polynomial",
                staleness_kwargs=dict(alpha=0.5), **STRAGGLER)
WEIGHTINGS = {"constant": {}, "polynomial": dict(alpha=0.5),
              "cutoff": dict(cutoff=1.0)}
SYNC_METRICS = ("loss", "drift", "update_norm", "bytes_up", "bytes_down",
                "round")
# the event stream: what the simulator and the byte accounting decide
EVENTS = ("staleness_hist", "staleness_max", "staleness_mean",
          "buffer_occupancy", "inflight", "dispatched", "dropped",
          "dropped_total", "sim_time", "sim_rounds_per_s", "bytes_up",
          "bytes_down", "round")
TOL = 1e-5


@pytest.fixture
def one_torch_thread():
    """These trainers are tiny (d 6, a 784 x 62 logreg): one intra-op
    thread runs them as fast, and keeps them from oversubscribing the
    cores when the suite runs in parallel workers (their time under
    six busy workers fell from 392 s to 145 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _module_one_torch_thread(one_torch_thread):
    yield


def _quad_spec(algorithm="scaffold", compress="none", server_optimizer="",
               **kw):
    return dict(num_clients=N, num_sampled=S, local_steps=4, local_batch=4,
                eta_l=0.05, eta_g=1.0, algorithm=algorithm, compress=compress,
                server_optimizer=server_optimizer, **kw)


@functools.lru_cache(maxsize=None)
def _quads():
    return make_similarity_quadratics(N, DIM, delta=0.5, G=1.0, seed=3)


def _quad_trainer(seed=7, spec_kw=None, **kw):
    return FederatedTrainer(
        quadratic_loss, lambda gen: {"x": torch.zeros(DIM)},
        TSpec(**_quad_spec(**(spec_kw or {}))), _quads(), seed=seed,
        device="cpu", **kw)


def _jax_quad_trainer(seed=7, spec_kw=None, **kw):
    return JTrainer(
        jax_quadratic_loss, lambda key: {"x": jnp.zeros((DIM,), jnp.float32)},
        JSpec(**_quad_spec(**(spec_kw or {}))),
        jax_quadratics(N, DIM, delta=0.5, G=1.0, seed=3), seed=seed, **kw)


EMNIST_DATA = dict(num_clients=10, samples=400, similarity_pct=0.0, seed=0,
                   test_samples=40)
EMNIST_SPEC = dict(algorithm="scaffold", num_clients=10, num_sampled=3,
                   local_steps=2, local_batch=4, eta_l=0.1,
                   compress="int8_ef")


@functools.lru_cache(maxsize=None)
def _emnist_data():
    return EmnistLikeFederated(**EMNIST_DATA)


@functools.lru_cache(maxsize=None)
def _logreg_weights():
    return jax.tree.map(np.asarray, logreg_init(jax.random.key(0), 784, 62))


def _emnist_trainer(seed=0, spec_kw=None, **kw):
    return FederatedTrainer(
        logreg_loss, lambda gen: params_from_jax(_logreg_weights(),
                                                 device="cpu"),
        TSpec(**{**EMNIST_SPEC, **(spec_kw or {})}), _emnist_data(),
        seed=seed, device="cpu", **kw)


def _jax_emnist_trainer(seed=0, spec_kw=None, **kw):
    w = _logreg_weights()
    return JTrainer(jax_logreg_loss,
                    lambda key: jax.tree.map(jnp.asarray, w),
                    JSpec(**{**EMNIST_SPEC, **(spec_kw or {})}),
                    JEmnist(**EMNIST_DATA), seed=seed, **kw)


def _state(tr):
    """x, c, the optimizer's slots and every row family, flat."""
    tr.sync_host_store()
    out = {f"x/{k}": v for k, v in tr.x.items()}
    out.update({f"c/{k}": v for k, v in tr.c.items()})
    out.update({f"opt/{k}/{j}": w for k, v in tr.server.opt_state.items()
                for j, w in (v.items() if isinstance(v, dict)
                             else [("", v)])})
    ids = np.arange(tr.store.num_clients)
    for name, st in tr._store_families():
        out.update({f"{name}/{k}": v for k, v in st.gather(ids).items()})
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _rows_np(tr, name):
    """A family's rows of either package as flat fp32 numpy."""
    st = {"c_i": tr.store, "residual": tr.residual_store,
          "solver": tr.solver_store}[name]
    rows = st.gather(np.arange(st.num_clients))
    out = {}
    for k, v in rows.items():
        if isinstance(v, dict):  # the reference's nested slot rows
            out.update({f"{k}/{j}": np.asarray(w, np.float32)
                        for j, w in v.items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v.float().numpy()
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _against_reference(jt, tt, int8=False):
    """x, c and every row family of the port within TOL of max|x| of the
    reference's. int8: the codec tests' structural allowance, each row family
    measured against the larger of max|x| and its own largest element
    (SCAFFOLD's c_i rows are ~5x x's scale on the logreg)."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jt.x.values())
    fams = [[(tt.x[k].numpy(), np.asarray(v)) for k, v in jt.x.items()]
            + [(tt.c[k].numpy(), np.asarray(v)) for k, v in jt.c.items()]]
    for name, _ in tt._store_families():
        got, want = _rows_np(tt, name), _rows_np(jt, name)
        assert sorted(got) == sorted(want), name
        fams.append([(got[k], want[k]) for k in want])
    errs = []
    for pairs in fams:
        own = max(float(np.abs(w).max()) for _, w in pairs)
        errs.append(np.concatenate([np.abs(g - w).ravel() for g, w in pairs])
                    / (max(scale, own) if int8 else scale))
    err = np.concatenate(errs)
    if not int8:
        assert err.max() <= TOL, err.max()
    else:
        assert (err > TOL).sum() <= err.size / 10_000, (err > TOL).sum()
        assert err.max() <= 1e-2, err.max()


# -- the staleness weights ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(WEIGHTINGS))
def test_staleness_weights_match_the_reference(name):
    assert TA.staleness_weighting_names() == JA.staleness_weighting_names()
    tau = np.arange(0, 40, dtype=np.float32)
    for kw in ({}, WEIGHTINGS[name], {"polynomial": dict(alpha=2.0),
                                      "cutoff": dict(cutoff=0.0)}.get(name,
                                                                      {})):
        tw = TA.make_staleness_weighting(name, **kw)
        jw = JA.make_staleness_weighting(name, **kw)
        assert tw.uniform == jw.uniform
        got = tw.weights(torch.from_numpy(tau))
        want = np.asarray(jw.weights(jnp.asarray(tau)), np.float32)
        assert got.dtype == torch.float32
        ulps = np.abs(got.numpy().view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, (kw, ulps.max())
    with pytest.raises(KeyError, match="unknown staleness weighting"):
        TA.make_staleness_weighting("psychic")


# -- the degenerate limit: the port's own sync loop, bitwise ------------------


def _degenerate_pair(make, s, spec_kw=None):
    sync = make(spec_kw=spec_kw)
    poof = make(spec_kw=spec_kw, async_buffer=s, max_inflight=s)
    assert poof.async_active and not sync.async_active
    return sync, poof


def _run_degenerate(sync, poof, rounds):
    for _ in range(rounds):
        ms, ma = sync.run_round(), poof.run_round()
        for key in SYNC_METRICS + ("dp_epsilon", "dp_clipped_frac"):
            assert ms.get(key) == ma.get(key), (key, ms.get(key),
                                                 ma.get(key))
    _assert_bitwise(_state(sync), _state(poof))


@pytest.mark.parametrize("algorithm,compress,server_opt", [
    ("scaffold", "none", ""),
    ("scaffold", "int8_ef", ""),
    ("scaffold", "none", "adam"),
    ("scaffold", "int8_ef", "adam"),
    ("scaffold_m", "none", ""),
    ("scaffold_m", "int8_ef", ""),
    ("scaffold_m", "none", "adam"),
    ("scaffold_m", "int8_ef", "adam"),
])
def test_degenerate_limit_is_bitwise_sync(algorithm, compress, server_opt):
    """M == K == S, always-on, zero latency, constant weighting: the
    port's async engine is the port's synchronous loop, bit for bit."""
    sync, poof = _degenerate_pair(_quad_trainer, S, dict(
        algorithm=algorithm, compress=compress, server_optimizer=server_opt))
    _run_degenerate(sync, poof, 6)


@pytest.mark.parametrize("spec_kw", [
    {},
    dict(weighted_aggregation=True, compress="none"),
], ids=["int8_ef", "weighted"])
def test_degenerate_limit_emnist_loader(spec_kw):
    """The same limit through the data-stream-consuming EMNIST loader
    (and its client sizes, weighted)."""
    sync, poof = _degenerate_pair(_emnist_trainer, 3, spec_kw)
    _run_degenerate(sync, poof, 5)


@pytest.mark.parametrize("spec_kw", [
    dict(privatizer="distributed_gauss", clip_norm=0.05,
         noise_multiplier=0.5, compress="randk_ef", compress_k=3),
    dict(privatizer="server_gauss", clip_norm=0.05, noise_multiplier=0.5,
         compress_downlink="int8_ef"),
    dict(local_solver="momentum", local_momentum=0.9, compress="topk_ef",
         compress_k=2),
    dict(local_solver="adam", algorithm="fedavg"),
], ids=["distributed-randk", "server-down-int8", "momentum-topk",
        "adam-fedavg"])
def test_degenerate_limit_through_privacy_codecs_and_solvers(spec_kw):
    sync, poof = _degenerate_pair(_quad_trainer, S, spec_kw)
    _run_degenerate(sync, poof, 4)


# -- against the reference's async engine under stragglers --------------------


def _cross(make_j, make_t, weighting, rounds=10, spec_kw=None):
    kw = dict(async_buffer=3, max_inflight=6, staleness_weighting=weighting,
              staleness_kwargs=WEIGHTINGS[weighting], **STRAGGLER)
    jt, tt = make_j(spec_kw=spec_kw, **kw), make_t(spec_kw=spec_kw, **kw)
    stale = 0
    for _ in range(rounds):
        mj, mt = jt.run_round(), tt.run_round()
        for key in EVENTS:
            assert mj[key] == mt[key], (key, mj[key], mt[key])
        stale += mt["staleness_max"]
    assert stale > 0 and tt.async_engine.dropped_total > 0
    return jt, tt


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
@pytest.mark.parametrize("compress", ["none", "int8_ef"])
def test_quadratics_match_the_reference_under_stragglers(weighting,
                                                         compress):
    jt, tt = _cross(_jax_quad_trainer, _quad_trainer, weighting,
                    spec_kw=dict(compress=compress))
    _against_reference(jt, tt)


@pytest.mark.parametrize("weighting", sorted(WEIGHTINGS))
def test_emnist_logreg_matches_the_reference_under_stragglers(weighting):
    jt, tt = _cross(_jax_emnist_trainer, _emnist_trainer, weighting)
    _against_reference(jt, tt, int8=True)


def jax_key(path):
    """The reference's key at a fold path: key(base) folded by the rest."""
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    return k


def jax_draws(kind, path, shape):
    """The reference's own draw at ``path`` (``streams.injected``)."""
    if kind == "permutation":
        return np.asarray(jax.random.permutation(jax_key(path), shape[0]))
    assert kind == "normal", kind
    return np.asarray(jax.random.normal(jax_key(path), tuple(shape),
                                        jnp.float32))


@pytest.mark.parametrize("spec_kw", [
    dict(compress="randk_ef", compress_k=3, privatizer="distributed_gauss",
         clip_norm=0.05, noise_multiplier=0.5),
    dict(compress_downlink="randk_ef", compress_k=4,
         privatizer="server_gauss", clip_norm=0.05, noise_multiplier=0.5),
], ids=["randk-distributed", "down-randk-server"])
def test_keyed_draws_match_the_reference(spec_kw):
    """The codec's and the noise's keyed draws at the async fold paths
    (version, position): with the reference's draws injected, the port
    follows the reference's async trajectory."""
    with streams.injected(jax_draws):
        jt, tt = _cross(_jax_quad_trainer, _quad_trainer, "polynomial",
                        rounds=6, spec_kw=spec_kw)
    assert tt.history[-1]["dp_epsilon"] == jt.history[-1]["dp_epsilon"]
    _against_reference(jt, tt)


# -- the reference's behavioural tests, on the port ---------------------------


def test_tiered_store_matches_dense_under_stragglers():
    dense = _quad_trainer(spec_kw=dict(compress="int8_ef"), **ASYNC_KW)
    tiered = [_quad_trainer(spec_kw=dict(compress="int8_ef"),
                            store="tiered", store_backend=backend,
                            **ASYNC_KW) for backend in ("dense", "memmap")]
    try:
        for _ in range(8):
            md = dense.run_round()
            for tr in tiered:
                assert tr.run_round() == md
        for tr in tiered:
            _assert_bitwise(_state(dense), _state(tr))
    finally:
        for tr in tiered:
            tr.close()


def test_observability_fields():
    tr = _quad_trainer(**ASYNC_KW)
    m = tr.run_round()
    for key in ("staleness_mean", "staleness_max", "staleness_hist",
                "buffer_occupancy", "inflight", "dispatched", "dropped",
                "dropped_total", "sim_time", "sim_rounds_per_s"):
        assert key in m, key
    assert sum(m["staleness_hist"]) == tr.async_engine.buffer_size
    assert m["sim_time"] > 0.0
    assert tr.client_store_device_bytes() == (6 + 3) * 4 * DIM


def test_run_and_history_work_in_async_mode():
    tr = _quad_trainer(**ASYNC_KW)
    tr.run(4)
    assert len(tr.history) == 4
    assert [h["round"] for h in tr.history] == [1, 2, 3, 4]
    assert tr.round_idx == 4


def test_dropped_update_never_lands():
    """Every dispatch of one client dies: its rows stay as they were and
    the dropped counters see every death."""

    class KillClient(UniformLatency):
        def __init__(self, victim, **kw):
            super().__init__(**kw)
            self.victim = victim

        def fate(self, client, k):
            lat, dropped = super().fate(client, k)
            return lat, dropped or client == self.victim

    victim = 4
    tr = _quad_trainer(spec_kw=dict(compress="int8_ef"), async_buffer=3,
                       max_inflight=6,
                       availability=KillClient(victim, seed=2, lo=0.5,
                                               hi=1.5))
    ids = np.array([victim])
    rows0 = tr.store.gather(ids)
    res0 = tr.residual_store.gather(ids)
    total = 0
    for _ in range(40):
        total += tr.run_round()["dropped"]
        if tr.async_engine.sim.dispatch_k[victim] >= 2:
            break
    assert tr.async_engine.sim.dispatch_k[victim] > 0
    assert total == tr.async_engine.dropped_total > 0
    _assert_bitwise(rows0, tr.store.gather(ids))
    _assert_bitwise(res0, tr.residual_store.gather(ids))
    # the other clients' rows did move
    assert not torch.equal(tr.store.gather(np.arange(N))["x"],
                           torch.zeros(N, DIM))


def test_staleness_weighting_changes_the_trajectory():
    base = dict(async_buffer=2, max_inflight=6, **STRAGGLER)
    const = _quad_trainer(**base, staleness_weighting="constant")
    poly = _quad_trainer(**base, staleness_weighting="polynomial",
                         staleness_kwargs=dict(alpha=2.0))
    saw_stale = diverged = False
    for _ in range(10):
        mc, mp = const.run_round(), poly.run_round()
        saw_stale = saw_stale or mc["staleness_max"] > 0
        diverged = diverged or mc["loss"] != mp["loss"]
    assert saw_stale and diverged


def test_cutoff_zero_freezes_on_stale_buffers():
    """cutoff=0 zeroes every stale update: an all-stale buffer is a
    no-op step (x unchanged, finite), never NaN."""
    tr = _quad_trainer(async_buffer=2, max_inflight=6,
                       staleness_weighting="cutoff",
                       staleness_kwargs=dict(cutoff=0.0), **STRAGGLER)
    froze = False
    for _ in range(10):
        x0 = tr.x["x"].clone()
        m = tr.run_round()
        assert np.isfinite(m["update_norm"])
        if min(i for i, n in enumerate(m["staleness_hist"]) if n) > 0:
            assert torch.equal(tr.x["x"], x0) and m["update_norm"] == 0.0
            froze = True
    assert froze
    assert torch.isfinite(tr.x["x"]).all()


def test_async_rejects_scan_pipeline_and_sequential():
    with pytest.raises(ValueError, match="scanned"):
        _quad_trainer(async_buffer=2, scan_rounds=4)
    with pytest.raises(ValueError, match="async"):
        _quad_trainer(async_buffer=2, pipeline_depth=1)
    with pytest.raises(ValueError, match="client_parallel"):
        _quad_trainer(spec_kw=dict(strategy="client_sequential"),
                      async_buffer=2)


def test_async_rejects_whole_batch_algorithms():
    with pytest.raises(ValueError, match="whole-batch"):
        _quad_trainer(spec_kw=dict(algorithm="sgd"), async_buffer=2)
