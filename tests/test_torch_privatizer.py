"""The port's privatizer registry against the JAX package's, on the CPU.

  * the clip meets its bound in truth: ``float(global_norm(clipped)) <=
    clip`` for every Hypothesis example (25, fp32 and bf16 leaves), the
    reference's failing example ``dim=1, scale=3.0, clip=1.4375``
    included; a tree within the bound comes back bitwise (the same
    tensors); the clipped values within 1e-6 relative of the reference's
    where the reference's own measure holds;
  * ``global_norm`` within 1e-6 relative of the reference's;
  * ``epsilon`` equal in float64, its fp32 twin within 1e-6;
  * noise with the reference's normals injected at the same fold paths
    (``core.streams.injected``): within 1 ulp (XLA may contract the
    multiply-add);
  * two trainer rounds of the EMNIST MLP under ``server_gauss`` and
    ``distributed_gauss`` (with ``int8_ef``'s residual rows too on the
    quadratics), both client strategies, against the reference's host
    loop: x within 1e-5 relative after round 1 and 1e-4 after round 2,
    ``dp_epsilon``, ``dp_clipped_frac`` and the bytes exact.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:
    # degrade per test, as the JAX package's property tests do
    def given(**kw):
        return lambda fn: pytest.mark.skip(
            reason="could not import 'hypothesis'")(fn)

    def settings(**kw):
        return lambda fn: fn

    def example(**kw):
        return lambda fn: fn

    class st:  # noqa: N801 — stands in for hypothesis.strategies
        integers = staticmethod(lambda a, b: None)
        floats = staticmethod(lambda a, b: None)
        sampled_from = staticmethod(lambda xs: None)

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import privatizer as JP
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.core import privatizer as TP
from repro_torch.core import streams
from test_torch_compression import (  # noqa: E402
    assert_rounds_match,
    emnist,  # noqa: F401  (a fixture)
    jax_draws,
    jax_key,
    pair_quadratic_trainers,
    pair_trainers,
)


def _tree(seed, dim, scale, dtype=torch.float32):
    """The reference test's tree: ``w`` (dim,), ``b`` (2, dim)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(dim,)) * scale).astype(np.float32)
    b = (rng.normal(size=(2, dim)) * scale).astype(np.float32)
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w).to(dtype),
             "b": torch.from_numpy(b).to(dtype)})


def test_registry_names_match():
    assert TP.privatizer_names() == JP.privatizer_names()
    for name in TP.privatizer_names():
        tp, jp = TP.get_privatizer(name), JP.get_privatizer(name)
        assert (tp.clips, tp.needs_key, tp.noise_at) == (
            jp.clips, jp.needs_key, jp.noise_at)
    with pytest.raises(KeyError, match="unknown privatizer"):
        TP.get_privatizer("laplace")


@settings(max_examples=25, deadline=None)
@given(dim=st.integers(1, 64), scale=st.floats(1e-3, 1e3),
       clip=st.floats(1e-3, 10.0), seed=st.integers(0, 2 ** 16),
       dtype=st.sampled_from(["float32", "bfloat16"]))
@example(dim=1, scale=3.0, clip=1.4375, seed=0, dtype="float32")
@example(dim=1, scale=3.0, clip=1.4375, seed=0, dtype="bfloat16")
def test_clip_norm_bound_is_exact(dim, scale, clip, seed, dtype):
    """The measure a caller takes of the clipped tree is <= clip."""
    _, tree = _tree(seed, dim, scale, getattr(torch, dtype))
    clipped, flag = TP.clip_by_global_norm(tree, clip)
    n_before = float(TP.global_norm(tree))
    assert float(TP.global_norm(clipped)) <= clip
    assert float(flag) == (1.0 if n_before > clip else 0.0)
    for k, v in tree.items():
        assert clipped[k].dtype == v.dtype and clipped[k].shape == v.shape


def test_reference_example_is_met_and_close_to_reference():
    """At the reference's failing example the port's measure holds, and
    its clipped values stay within 1e-6 of the reference's."""
    jt, tt = _tree(0, 1, 3.0)
    clipped, flag = TP.clip_by_global_norm(tt, 1.4375)
    assert float(TP.global_norm(clipped)) <= 1.4375 and float(flag) == 1.0
    jc, jflag = JP.clip_by_global_norm(jt, 1.4375)
    assert float(jflag) == 1.0
    for k in tt:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("dim,scale,clip,seed", [
    (6, 1.0, 0.5, 0), (64, 10.0, 3.0, 1), (17, 0.1, 0.05, 2),
    (1, 1e3, 1e-3, 3)])
def test_clip_matches_reference(dim, scale, clip, seed):
    jt, tt = _tree(seed, dim, scale)
    np.testing.assert_allclose(float(TP.global_norm(tt)),
                               float(JP.global_norm(jt)), rtol=1e-6)
    clipped, flag = TP.clip_by_global_norm(tt, clip)
    jc, jflag = JP.clip_by_global_norm(jt, clip)
    assert float(flag) == float(jflag) == 1.0
    for k in tt:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-6 * clip)


@settings(max_examples=25, deadline=None)
@given(dim=st.integers(1, 64), seed=st.integers(0, 2 ** 16))
def test_clip_identity_below_threshold(dim, seed):
    _, tree = _tree(seed, dim, 1.0)
    clip = float(TP.global_norm(tree)) * 2.0 + 1.0
    clipped, flag = TP.clip_by_global_norm(tree, clip)
    assert float(flag) == 0.0
    for k, v in tree.items():
        assert clipped[k] is v


def test_clip_inf_zeroes_and_nan_passes():
    inf = {"a": torch.tensor([float("inf"), 1.0])}
    out, flag = TP.clip_by_global_norm(inf, 1.0)
    assert float(flag) == 1.0 and not out["a"].any()
    nan = {"a": torch.tensor([float("nan"), 1.0])}
    out, flag = TP.clip_by_global_norm(nan, 1.0)
    assert float(flag) == 0.0 and out["a"] is nan["a"]


@pytest.mark.parametrize("s,n,z,delta", [
    (10, 50, 1.0, 1e-5), (3, 10, 0.7, 1e-3), (1, 1000, 4.0, 1e-8)])
def test_epsilon_equal_in_float64(s, n, z, delta):
    kw = dict(algorithm="scaffold", num_clients=n, num_sampled=s,
              local_steps=1, local_batch=1, privatizer="server_gauss",
              clip_norm=1.0, noise_multiplier=z, dp_delta=delta)
    js, ts = JSpec(**kw), TSpec(**kw)
    for name in ("server_gauss", "distributed_gauss", "none"):
        tp, jp = TP.get_privatizer(name), JP.get_privatizer(name)
        for t in (1, 2, 7, 150, 10_000):
            assert tp.epsilon(ts, t) == jp.epsilon(js, t)
    q = s / n
    a = 2.0 * 150 * q * q / z ** 2
    assert TP.get_privatizer("server_gauss").epsilon(ts, 150) == (
        a + 2.0 * math.sqrt(a * math.log(1.0 / delta)))


@pytest.mark.parametrize("name", ["server_gauss", "distributed_gauss"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_with_injected_normals(name, dtype):
    kw = dict(algorithm="scaffold", num_clients=10, num_sampled=4,
              local_steps=1, local_batch=1, privatizer=name, clip_norm=0.8,
              noise_multiplier=1.3)
    js, ts = JSpec(**kw), TSpec(**kw)
    jt, tt = _tree(5, 9, 0.4, getattr(torch, dtype))
    jt = {k: v.astype(getattr(jnp, dtype)) for k, v in jt.items()}
    tp, jp = TP.get_privatizer(name), JP.get_privatizer(name)
    path = (13, 4, 1) if name == "server_gauss" else (13, 4, 0, 2)
    tkey, jkey = streams.StreamKey(path, "cpu"), jax_key(path)
    with streams.injected(jax_draws):
        if name == "server_gauss":
            got, want = tp.server_noise(ts, tt, tkey), jp.server_noise(
                js, jt, jkey)
        else:
            got, want = tp.client_noise(ts, tt, tkey), jp.client_noise(
                js, jt, jkey)
    for k in tt:
        assert got[k].dtype == tt[k].dtype
        g = got[k].float().numpy()
        w = np.asarray(want[k].astype(jnp.float32))
        # the spacing of fp32 at |w|; bf16 keeps 16 fewer bits
        ulp = np.spacing(np.abs(w)) * (2.0 ** 16 if dtype == "bfloat16"
                                       else 1.0)
        assert (np.abs(g - w) <= ulp).all(), k


def test_noise_draws_are_keyed_by_leaf():
    seen = []
    _, tt = _tree(0, 3, 1.0)
    with streams.injected(lambda kind, path, shape: seen.append(
            (kind, path)) or np.zeros(shape)):
        out = TP.gaussian_noise_like(tt, streams.StreamKey((9, 1, 1), "cpu"),
                                     0.5)
    # flatten order: "b" before "w"
    assert seen == [("normal", (9, 1, 1, 0)), ("normal", (9, 1, 1, 1))]
    assert list(out) == list(tt)


@pytest.mark.parametrize("name", ["server_gauss", "distributed_gauss"])
@pytest.mark.parametrize("strategy", ["client_parallel", "client_sequential"])
def test_trainer_rounds_with_privatizer(emnist, name, strategy):  # noqa: F811
    kw = dict(privatizer=name, clip_norm=1.0, noise_multiplier=0.5,
              strategy=strategy)
    exact = ("bytes_up", "bytes_down", "dp_epsilon", "dp_clipped_frac")
    jt, tt = pair_trainers(emnist, **kw)
    with streams.injected(jax_draws):
        mj, mt = assert_rounds_match(jt, tt, exact=exact)
    assert mt["dp_epsilon"] == TP.get_privatizer(name).epsilon(tt.spec, 2)
    assert 0.0 < mt["dp_clipped_frac"] <= 1.0
    # with int8's residual rows (the quadratics: see the compression tests)
    jt, tt = pair_quadratic_trainers(compress="int8_ef", **kw)
    with streams.injected(jax_draws):
        assert_rounds_match(jt, tt, exact=exact)
    assert tt.residual_store.gather(np.arange(10))["x"].any()
