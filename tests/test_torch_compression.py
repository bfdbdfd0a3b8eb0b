"""The port's compressor registry against the JAX package's, on the CPU.

  * every codec's ``encode``, ``decode``, ``payload_bytes``,
    ``round_trip`` (reconstruction and residual) and ``apply_stateless``
    on the same trees: bitwise where both sides do the same fp32
    operations, 1e-6 relative for ``sign_ef``'s mean-|x| scale (a
    summation order); ``randk_ef`` with the reference's permutations
    injected at the same fold paths (``core.streams.injected``);
  * ``topk_ef`` on tied magnitudes: lower index first, ``lax.top_k``'s
    order;
  * the int8 helpers and ``round_comm_bytes`` as exact ints for every
    uplink and downlink codec and every algorithm;
  * two trainer rounds of the EMNIST MLP with each codec (residual rows
    carried) against the reference's host loop: x within 1e-5 relative
    after round 1 and 1e-4 after round 2, the residual rows within 1e-4,
    the bytes exact.
  * ``int8_ef`` rounds to a grid: the two packages' dy differ by fp32
    summation order (~2e-7 relative), which puts a few of the MLP's
    216,894 elements on the other side of a rounding boundary, one int8
    step of one client apart (3 elements after round 1, 2.1e-4 of
    max|x|). So the int8 rounds are held at those tolerances on the
    reference's own quadratic problem (N 10, d 6, as its privatizer
    tests), and on the MLP by that structure: after one round at most
    1 element in 10,000 beyond 1e-5 relative, none beyond 1e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.core import compression as JC
from repro.core.api import get_algorithm as jax_get_algorithm
from repro.data import EmnistLikeFederated as JEmnist
from repro.models import simple as JS
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.core import compression as TC
from repro_torch.core import streams
from repro_torch.core.api import algorithm_names, get_algorithm
from repro.data import make_similarity_quadratics as jax_quadratics
from repro.data import quadratic_loss as jax_quadratic_loss
from repro_torch.data import EmnistLikeFederated as TEmnist
from repro_torch.data import make_similarity_quadratics, quadratic_loss
from repro_torch.models import simple as TS

CODECS = ("none", "int8_ef", "topk_ef", "randk_ef", "sign_ef")
PATH = (5, 2, 0, 1)  # (base, round, client branch, client)


def jax_key(path):
    """The reference's key at a fold path: key(base) folded by the rest."""
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    return k


@functools.lru_cache(maxsize=None)
def _jax_draw(kind, path, shape):
    if kind == "permutation":
        return np.asarray(jax.random.permutation(jax_key(path), shape[0]))
    return np.asarray(jax.random.normal(jax_key(path), shape, jnp.float32))


def jax_draws(kind, path, shape):
    """The reference's own draw at ``path`` (``streams.injected``)."""
    return _jax_draw(kind, tuple(path), tuple(shape))


def _spec(codec, k=4, down="none"):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, compress=codec, compress_k=k,
              compress_downlink=down)
    return JSpec(**kw), TSpec(**kw)


def _trees(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tree = {"w1": rng.normal(size=(5, 7)) * scale,
            "b1": rng.normal(size=(7,)) * scale,
            "w2": rng.normal(size=(7, 3)) * scale,
            "b2": np.zeros(3)}
    tree = {k: v.astype(dtype) for k, v in tree.items()}
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _np(tree):
    """Flat fp32 numpy leaves of a tree or payload of either package (the
    randk payload's key, a simulation convenience, left out)."""
    out = {}
    for k, v in flatten_tree(tree).items():
        if k.split("/")[-1] == "key":
            continue
        out[k] = (v.float().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v, np.float32))
    return out


def _assert_trees(got, want, rtol=0.0):
    g, w = _np(got), _np(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if rtol:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=rtol * max(
                float(np.abs(w[k]).max()), 1e-30), err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_registry_names_match():
    assert TC.compressor_names() == JC.compressor_names() == tuple(
        sorted(CODECS))
    for name in CODECS:
        tc, jc = TC.get_compressor(name), JC.get_compressor(name)
        assert (tc.stateful, tc.needs_key) == (jc.stateful, jc.needs_key)
    with pytest.raises(KeyError, match="unknown compressor"):
        TC.get_compressor("zip")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", [1, 4, 64])
def test_codec_matches_reference(codec, k):
    js, ts = _spec(codec, k)
    jc, tc = JC.get_compressor(codec), TC.get_compressor(codec)
    jt, tt = _trees(k, scale=0.3)
    jr, tr = _trees(100 + k, scale=0.01)
    jkey = jax_key(PATH) if jc.needs_key else None
    tkey = streams.StreamKey(PATH, "cpu") if tc.needs_key else None
    # sign's scale is a mean: the two sums run in different orders
    tol = 1e-6 if codec == "sign_ef" else 0.0
    with streams.injected(jax_draws):
        _assert_trees(tc.encode(ts, tt, key=tkey),
                      jc.encode(js, jt, key=jkey), tol)
        _assert_trees(tc.decode(ts, tc.encode(ts, tt, key=tkey), tt),
                      jc.decode(js, jc.encode(js, jt, key=jkey), jt), tol)
        _assert_trees(tc.apply_stateless(ts, tt, key=tkey),
                      jc.apply_stateless(js, jt, key=jkey), tol)
        for jres, tres in ((None, None), (jr, tr)):
            trec, tnew = tc.round_trip(ts, tt, tres, key=tkey)
            jrec, jnew = jc.round_trip(js, jt, jres, key=jkey)
            _assert_trees(trec, jrec, tol)
            if jnew is None:
                assert tnew is None
            else:
                _assert_trees(tnew, jnew, tol)
    assert tc.payload_bytes(ts, tt) == jc.payload_bytes(js, jt)
    assert (tc.init_residual(tt) is None) == (jc.init_residual(jt) is None)


def test_round_trip_telescopes_and_keeps_dtypes():
    """The error-feedback invariant (reconstruction + new residual ==
    delta + old residual, in fp32) and the delta's dtypes, bf16 too."""
    _, tt = _trees(3, dtype=np.float32)
    tt["w1"] = tt["w1"].to(torch.bfloat16)
    _, tr = _trees(4, scale=0.05)
    ts = _spec("int8_ef")[1]
    for name in ("int8_ef", "topk_ef", "sign_ef"):
        rec, res = TC.get_compressor(name).round_trip(ts, tt, tr)
        for k in tt:
            assert rec[k].dtype == tt[k].dtype and res[k].dtype == torch.float32
            if tt[k].dtype == torch.float32:
                torch.testing.assert_close(rec[k] + res[k], tt[k] + tr[k],
                                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
def test_topk_ties_go_to_the_lower_index(k):
    x = np.array([0.5, -2.0, 2.0, -0.5, 2.0, 1.0, -1.0, 0.5, 0.0, -2.0],
                 np.float32)
    js, ts = _spec("topk_ef", k)
    jp = JC.get_compressor("topk_ef").encode(js, {"a": jnp.asarray(x)})
    tp = TC.get_compressor("topk_ef").encode(ts, {"a": torch.from_numpy(x)})
    np.testing.assert_array_equal(tp["a"]["idx"].numpy(),
                                  np.asarray(jp["a"]["idx"]))
    assert tp["a"]["idx"].dtype == torch.int32
    want = sorted(range(len(x)), key=lambda i: (-abs(x[i]), i))[:k]
    assert tp["a"]["idx"].tolist() == want


def test_randk_draws_are_keyed_and_replayable():
    """A pure function of the fold path: the same key gives the same
    mask on every call, another client another mask; leaf j folds j."""
    ts = _spec("randk_ef", 4)[1]
    tc = TC.get_compressor("randk_ef")
    _, tt = _trees(0)
    key = streams.round_key(7, 3, "cpu").fold_in(0)
    a = tc.encode(ts, tt, key=key.fold_in(1))
    b = tc.encode(ts, tt, key=key.fold_in(1))
    c = tc.encode(ts, tt, key=key.fold_in(2))
    for leaf in tt:
        torch.testing.assert_close(a[leaf]["val"], b[leaf]["val"], rtol=0,
                                   atol=0)
    assert any(not torch.equal(a[leaf]["val"], c[leaf]["val"])
               for leaf in ("w1", "w2"))
    seen = []
    with streams.injected(lambda kind, path, shape: seen.append(path)
                          or np.arange(shape[0])):
        tc.encode(ts, tt, key=key.fold_in(1))
    assert seen == [(7, 3, 0, 1, j) for j in range(4)]
    with pytest.raises(ValueError, match="keyed"):
        tc.encode(ts, tt)


def test_int8_helpers_match():
    jt, tt = _trees(9, scale=2.0)
    jr, tr = _trees(10, scale=0.01)
    jq, js_ = JC.quantize_int8(jt)
    tq, ts_ = TC.quantize_int8(tt)
    _assert_trees(tq, jq)
    _assert_trees(ts_, js_)
    assert all(v.dtype == torch.int8 for v in tq.values())
    _assert_trees(TC.dequantize_int8(tq, ts_), JC.dequantize_int8(jq, js_))
    for got, want in zip(TC.compress_delta(tt, tr), JC.compress_delta(jt, jr)):
        _assert_trees(got, want)
    assert TC.uplink_bytes(tt) == JC.uplink_bytes(jt)
    assert TC.compressed_uplink_bytes(tt) == JC.compressed_uplink_bytes(jt)
    assert TC.tree_bytes(tt) == JC.tree_bytes(jt)
    # half to even, as jnp.round: 0.5 and 2.5 * scale land on 0 and 2
    x = np.array([127.0, 0.5, 2.5, -1.5, -127.0], np.float32)
    q, _ = TC.quantize_int8({"a": torch.from_numpy(x)})
    assert q["a"].tolist() == [127, 0, 2, -2, -127]


@pytest.mark.parametrize("up", CODECS)
@pytest.mark.parametrize("down", CODECS)
def test_round_comm_bytes_exact(up, down):
    _, tt = _trees(0)
    jt = jax.tree.map(lambda v: jnp.asarray(v.numpy()), tt)
    for algo in algorithm_names():
        if algo == "sgd":
            continue  # whole batch: no codec (the spec refuses one)
        js, ts = (dataclasses.replace(s, algorithm=algo, compress_k=5)
                  for s in _spec(up, 4, down))
        stateful = get_algorithm(algo).stateful_clients
        assert stateful == jax_get_algorithm(algo).stateful_clients
        got = TC.round_comm_bytes(ts, tt, stateful_clients=stateful)
        want = JC.round_comm_bytes(js, jt, stateful_clients=stateful)
        assert got == want and all(type(v) is int for v in got.values())


# ----------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def emnist():
    kw = dict(num_clients=10, samples=2000, similarity_pct=10.0, seed=0)
    w = jax.tree.map(np.asarray, JS.mlp_init(jax.random.key(1), 784, 62))
    return JEmnist(**kw), TEmnist(**kw), w


def pair_trainers(emnist, **kw):
    jd, td, w = emnist
    base = dict(algorithm="scaffold", num_clients=10, num_sampled=4,
                local_steps=5, local_batch=jd.local_batch_size(0.2),
                eta_l=0.3)
    base.update(kw)
    jt = JTrainer(JS.mlp_loss, lambda key: jax.tree.map(jnp.asarray, w),
                  JSpec(**base), jd, seed=0, use_fused_update=True)
    tt = FederatedTrainer(TS.mlp_loss,
                          lambda gen: params_from_jax(w, device="cpu"),
                          TSpec(**base), td, seed=0, use_fused_update=True,
                          device="cpu")
    return jt, tt


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_rounds_match(jt, tt, rounds=2, exact=("bytes_up", "bytes_down")):
    for r in range(rounds):
        mj, mt = jt.run_round(), tt.run_round()
        assert sorted(mj) == sorted(mt)
        for k in exact:
            assert mt[k] == mj[k], k
        err = max(rel(tt.x[k].numpy(), v) for k, v in jt.x.items())
        assert err <= (1e-5 if r == 0 else 1e-4), (r, err)
    return mj, mt


@pytest.mark.parametrize("up,down,strategy", [
    ("topk_ef", "none", "client_parallel"),
    ("randk_ef", "none", "client_sequential"),
    ("sign_ef", "none", "client_parallel"),
    ("topk_ef", "sign_ef", "client_sequential"),
    ("randk_ef", "randk_ef", "client_parallel"),
])
def test_trainer_rounds_with_codecs(emnist, up, down, strategy):
    jt, tt = pair_trainers(emnist, compress=up, compress_downlink=down,
                           strategy=strategy)
    assert (tt.residual_store is None) == (jt.residual_store is None)
    with streams.injected(jax_draws):
        assert_rounds_match(jt, tt)
    if tt.residual_store is not None:
        ids = np.arange(10)
        want = jt.residual_store.gather(ids)
        got = tt.residual_store.gather(ids)
        assert any(v.any() for v in got.values())
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            assert rel(got[k].numpy(), v) <= 1e-4, k


def pair_quadratic_trainers(**kw):
    """The reference privatizer tests' problem: N 10 quadratics, d 6."""
    base = dict(algorithm="scaffold", num_clients=10, num_sampled=3,
                local_steps=4, local_batch=1, eta_l=0.05, eta_g=0.7)
    base.update(kw)
    args = dict(num_clients=10, dim=6, delta=0.3, G=4.0, mu=0.3, seed=1)
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((6,), jnp.float32)},
                  JSpec(**base), jax_quadratics(**args), seed=0,
                  use_fused_update=True)
    tt = FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(6)},
                          TSpec(**base), make_similarity_quadratics(**args),
                          seed=0, use_fused_update=True, device="cpu")
    return jt, tt


@pytest.mark.parametrize("down", ["none", "int8_ef"])
@pytest.mark.parametrize("strategy", ["client_parallel", "client_sequential"])
def test_trainer_rounds_with_int8(emnist, down, strategy):
    jt, tt = pair_quadratic_trainers(compress="int8_ef",
                                     compress_downlink=down,
                                     strategy=strategy)
    assert_rounds_match(jt, tt, rounds=3)
    ids = np.arange(10)
    want, got = jt.residual_store.gather(ids), tt.residual_store.gather(ids)
    assert got["x"].any()
    assert rel(got["x"].numpy(), want["x"]) <= 1e-4
    # the MLP: every element but a few rounding-boundary crossings
    jt, tt = pair_trainers(emnist, compress="int8_ef",
                           compress_downlink=down, strategy=strategy)
    mj, mt = jt.run_round(), tt.run_round()
    assert (mt["bytes_up"], mt["bytes_down"]) == (mj["bytes_up"],
                                                 mj["bytes_down"])
    xj = {k: np.asarray(v) for k, v in jt.x.items()}
    scale = max(float(np.abs(v).max()) for v in xj.values())
    diff = {k: np.abs(tt.x[k].numpy() - v) for k, v in xj.items()}
    n = sum(v.size for v in diff.values())
    beyond = sum(int((d > 1e-5 * scale).sum()) for d in diff.values())
    assert beyond <= n // 10_000, beyond
    assert max(float(d.max()) for d in diff.values()) <= 1e-3 * scale
