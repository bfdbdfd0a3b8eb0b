"""The port's scanned engine (``FederatedTrainer(scan_rounds=R)``,
``core.api.run_rounds``) on the CPU.

  * bitwise against the port's own per-round host loop on the device RNG
    contract (``_host_loop``, a twin of the reference's
    ``tests/test_scan_engine.py::_host_loop_device_rng``) over {scaffold,
    fedavg, fedprox, scaffold_m} x {sgd, momentum, adam} x fused on/off,
    every codec, every local solver and both privatizers, the whole-batch
    sgd baseline, weighted EMNIST and the synthetic LM;
  * chunk-size invariance, and a resume mid-chunk, bitwise;
  * checkpoints across engines, and into the reference's trainer and
    back;
  * the fallback's warning and reason, the reference's ValueError;
  * each dataset's ``device_batch_fn`` equal to the reference's on the
    reference's own draws (``streams.injected``);
  * the scanned trainer against the reference's scanned trainer on the
    reference's cohorts and uniforms: x, c and every store row to 1e-5
    of each leaf's scale (1e-4 for the LM), byte counts equal;
  * the launch tally that counts a CUDA graph's replays.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_trainer as jax_load_trainer
from repro.checkpoint import save_trainer as jax_save_trainer
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import EmnistLikeFederated as JEmnist
from repro.data import SyntheticLMFederated as JLM
from repro.data import make_similarity_quadratics as jax_sim
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.models import model as JM
from repro.models import simple as JS
from repro_torch.checkpoint import load_trainer, save_trainer
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core import (
    ClientRoundState,
    ClientStateStore,
    FederatedTrainer,
    device_sample_ids,
    get_compressor,
    get_local_solver,
    init_server_state,
    make_grad_fn,
    resolve_local_solver,
    run_round,
    run_rounds,
    streams,
)
from repro_torch.core.streams import round_key, stream_key
from repro_torch.core.tree import tree_flatten_slots
from repro_torch.data import (
    EmnistLikeFederated,
    SyntheticLMFederated,
    make_similarity_quadratics,
    quadratic_loss,
)
from repro_torch.kernels import counts
from repro_torch.models import model as TM
from repro_torch.models import simple as TS

N, S, K, DIM = 10, 3, 4, 6
ROUNDS = 3


def _spec(algo="scaffold", server_opt="sgd", **kw):
    return TSpec(algorithm=algo, num_clients=N, num_sampled=S, local_steps=K,
                 local_batch=1, eta_l=0.05, eta_g=0.7,
                 server_optimizer=server_opt,
                 server_momentum=0.8 if server_opt == "momentum" else 0.0,
                 **kw)


def _init(gen=None):
    return {"x": torch.ones(DIM)}


@functools.lru_cache(maxsize=None)
def _quads():
    return make_similarity_quadratics(N, DIM, delta=0.3, G=4.0, mu=0.3,
                                      seed=1)


def _trainer(spec, ds=None, loss_fn=quadratic_loss, init=_init, **kw):
    return FederatedTrainer(loss_fn, init, spec, ds or _quads(), seed=0,
                            device="cpu", **kw)


def _host_loop(spec, ds, rounds, loss_fn=quadratic_loss, init=_init,
               fused=False, seed=0):
    """``rounds`` calls of ``run_round`` on the scanned engine's streams:
    cohorts ``device_sample_ids(stream_key(seed), t)``, batches from the
    dataset's ``device_batch_fn`` at ``stream_key(seed + 1).fold_in(t)``,
    the keyed streams at ``seed + 2`` and ``seed + 3``, every row family
    gathered from and scattered to host stores. Returns ``(server,
    {family: rows}, history)``."""
    grad_fn = make_grad_fn(loss_fn)
    data = ds.device_data(device="cpu")
    batch_fn = ds.device_batch_fn(spec.local_steps, spec.local_batch)
    skey, dkey = stream_key(seed, "cpu"), stream_key(seed + 1, "cpu")
    params = init(None)
    server = init_server_state(spec, params)
    stores = {"c_i": ClientStateStore(params, spec.num_clients)}
    if get_compressor(spec.compress).stateful:
        stores["residual"] = ClientStateStore(
            {k: v.float() for k, v in params.items()}, spec.num_clients)
    solver = get_local_solver(resolve_local_solver(spec))
    if solver.stateful:
        stores["solver"] = ClientStateStore(
            tree_flatten_slots(solver.init(spec, params)), spec.num_clients)
    sizes = (ds.device_client_sizes(device="cpu")
             if spec.weighted_aggregation else None)
    hist = []
    for t in range(rounds):
        ids = device_sample_ids(skey, t, spec.num_clients, spec.num_sampled)
        batches = batch_fn(data, ids, dkey.fold_in(t))
        rows = {name: st.gather(ids) for name, st in stores.items()}
        clients = ClientRoundState(
            c_i=rows["c_i"], uplink_residual=rows.get("residual"),
            solver_slots=rows.get("solver"),
            weights=None if sizes is None else sizes[ids])
        out = run_round(grad_fn, spec, server, clients, batches,
                        use_fused_update=fused,
                        comp_key=round_key(seed + 2, t, "cpu"),
                        priv_key=round_key(seed + 3, t, "cpu"), dp_round=t)
        server = out.server
        new = {"c_i": out.clients.c_i,
               "residual": out.clients.uplink_residual,
               "solver": out.clients.solver_slots}
        for name, st in stores.items():
            st.scatter(ids, new[name])
        hist.append({k: float(v) for k, v in out.metrics.items()})
    return server, {name: st.all_rows() for name, st in stores.items()}, hist


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal(a[k], b[k])
    else:
        assert torch.equal(a, b), (a, b)


def _families(tr):
    return tr._device_families()


def _assert_matches_host_loop(spec, ds=None, loss_fn=quadratic_loss,
                              init=_init, fused=False, rounds=ROUNDS):
    ds = ds or _quads()
    server_h, stores_h, hist_h = _host_loop(spec, ds, rounds, loss_fn, init,
                                            fused=fused)
    tr = _trainer(spec, ds, loss_fn, init, scan_rounds=rounds,
                  use_fused_update=fused)
    assert tr.scan_active, tr.scan_fallback_reason
    tr.run(rounds)
    _assert_equal(server_h.x, tr.x)
    _assert_equal(server_h.c, tr.c)
    _assert_equal(server_h.opt_state, tr.server.opt_state)
    _assert_equal(stores_h, _families(tr))
    host_only = ("round", "megakernel_fallback_reason")
    assert hist_h == [{k: v for k, v in h.items() if k not in host_only}
                      for h in tr.history]
    if spec.use_megakernel:
        assert {h["megakernel_fallback_reason"] for h in tr.history} == {""}
    return tr


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("server_opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("algo",
                         ["scaffold", "fedavg", "fedprox", "scaffold_m"])
def test_scanned_matches_host_loop(algo, server_opt, fused):
    """One chunk of R rounds equals R host-loop rounds bitwise: server x,
    c and slots, the whole device store, the metrics."""
    _assert_matches_host_loop(_spec(algo, server_opt), fused=fused)


CODECS = ("none", "int8_ef", "topk_ef", "randk_ef", "sign_ef")
SOLVERS = ("sgd", "momentum", "adam", "sgd_sched")


def _solver_kw(solver):
    return dict(local_solver=solver,
                eta_l_schedule="cosine" if solver == "sgd_sched" else "")


CASES = {
    **{f"{codec}-{algo}": (_spec(algo, compress=codec, compress_k=3), False)
       for codec in CODECS for algo in ("scaffold", "scaffold_m")},
    **{f"up {up}, down {down}": (_spec("scaffold", "momentum", compress=up,
                                       compress_k=2, compress_downlink=down),
                                 False)
       for up, down in (("randk_ef", "int8_ef"), ("int8_ef", "randk_ef"))},
    **{f"{solver}-{algo}-{'fused' if fused else 'plain'}": (
        _spec(algo, **_solver_kw(solver)), fused)
       for solver in SOLVERS for algo in ("scaffold", "scaffold_m")
       for fused in (False, True)},
    **{f"option I, {solver}": (_spec(scaffold_option="I",
                                     **_solver_kw(solver)), False)
       for solver in ("sgd", "momentum")},
    "momentum solver and int8": (
        _spec(compress="int8_ef", **_solver_kw("momentum")), False),
    **{f"{priv}, {codec}": (_spec("scaffold", "momentum", privatizer=priv,
                                  clip_norm=0.5, noise_multiplier=1.1,
                                  compress=codec), False)
       for priv in ("server_gauss", "distributed_gauss")
       for codec in ("none", "int8_ef")},
    "whole-batch sgd": (TSpec(algorithm="sgd", num_clients=N, num_sampled=S,
                              local_steps=K, local_batch=1, eta_l=0.05),
                        False),
    "megakernel": (_spec(use_megakernel=True), True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scanned_matches_host_loop_configs(name):
    """Every codec (residuals as device-store rows), both downlinks, every
    local solver (slots as device-store rows), option I, both privatizers
    (the privacy stream, the exact clip, the Gaussian draws), the
    whole-batch baseline and the K-step kernel path: one scanned chunk
    equals the host loop bitwise."""
    spec, fused = CASES[name]
    tr = _assert_matches_host_loop(spec, fused=fused)
    if spec.compress != "none" and get_compressor(spec.compress).stateful:
        assert float(_families(tr)["residual"]["x"].abs().sum()) > 0
    if spec.local_solver in ("momentum", "adam"):
        assert float(_families(tr)["solver"]["m/x"].abs().sum()) > 0
    if spec.privatizer != "none":
        eps = [h["dp_epsilon"] for h in tr.history]
        assert all(b > a for a, b in zip(eps, eps[1:]))


def _emnist(weighted=True, n=8):
    spec = TSpec(algorithm="scaffold", num_clients=n, num_sampled=3,
                 local_steps=3, local_batch=4, eta_l=0.1,
                 weighted_aggregation=weighted)
    ds = EmnistLikeFederated(num_clients=n, samples=600, similarity_pct=10.0,
                             seed=0, test_samples=50)
    init = lambda gen: TS.logreg_init(gen, 784, 62, device="cpu")  # noqa
    return spec, ds, init


def _lm_oh():
    """A one-hot "embedding" LM over 64 tokens: differentiable and fast."""

    def loss(params, batch):
        oh = torch.nn.functional.one_hot(batch["tokens"], 64).float()
        logp = torch.log_softmax(oh @ params["w"], dim=-1)
        ll = torch.gather(logp, -1, batch["labels"][..., None])
        loss = -ll.mean()
        return loss, {"loss": loss}

    spec = TSpec(algorithm="scaffold_m", num_clients=6, num_sampled=2,
                 local_steps=2, local_batch=2, eta_l=0.05)
    ds = SyntheticLMFederated(6, vocab_size=64, seq_len=12, seed=0)
    return spec, ds, loss, lambda gen: {"w": torch.zeros(64, 64)}


@pytest.mark.parametrize("data", ["emnist weighted", "emnist", "lm"])
def test_scanned_matches_host_loop_data(data):
    """The EMNIST device path (the padded shard table, the uniform
    positions; size-weighted or not) and the synthetic LM's (uniform,
    categorical, the structure rewrite) run the scanned engine bitwise
    as the host loop on the same streams."""
    if data == "lm":
        spec, ds, loss, init = _lm_oh()
        _assert_matches_host_loop(spec, ds, loss, init, rounds=4)
    else:
        spec, ds, init = _emnist(weighted=data == "emnist weighted")
        _assert_matches_host_loop(spec, ds, TS.logreg_loss, init, rounds=4)


@pytest.mark.parametrize("spec_kw,chunks", [
    (dict(server_opt="momentum"), (1, 1, 1, 1, 1, 1)),
    (dict(server_opt="momentum"), (2, 4)),
    (dict(server_opt="momentum"), (6,)),
    (dict(server_opt="momentum"), (4, 2)),
    (dict(server_opt="momentum"), (3, 3)),
    (dict(server_opt="momentum", compress="randk_ef", compress_k=2),
     (1, 2, 3)),
    (dict(privatizer="server_gauss", clip_norm=0.5, noise_multiplier=1.1),
     (4, 1, 1)),
], ids=["1x6", "2+4", "6", "4+2", "3+3", "randk 1+2+3", "server_gauss 4+1+1"])
def test_chunk_size_invariance(spec_kw, chunks):
    """Any chunking of 6 rounds gives the same bits (``run_round`` is a
    chunk of one), keyed codecs and privacy streams included."""
    spec = _spec(**spec_kw)
    ref = _trainer(spec, scan_rounds=6)
    ref.run(6)
    tr = _trainer(spec, scan_rounds=max(chunks))
    for c in chunks:
        tr._run_scan_chunk(c)
    _assert_equal(ref.x, tr.x)
    _assert_equal(_families(ref), _families(tr))
    assert ref.history == tr.history


def test_draws_ahead_in_pieces_when_a_round_draws_much(monkeypatch):
    """Past the draw budget a chunk is drawn and run in pieces: the same
    bits as one piece."""
    import repro_torch.core.controller as C

    spec = _spec(privatizer="distributed_gauss", clip_norm=0.5,
                 noise_multiplier=1.1, compress="randk_ef", compress_k=2)
    ref = _trainer(spec, scan_rounds=6)
    ref.run(6)
    monkeypatch.setattr(C, "DRAW_AHEAD_BYTES", 1)
    tr = _trainer(spec, scan_rounds=6)
    tr.run(6)
    assert tr._ahead.capacity == 1
    _assert_equal(ref.x, tr.x)
    _assert_equal(_families(ref), _families(tr))
    assert ref.history == tr.history


def test_run_rounds_direct_api():
    """The engine without a trainer: typed in, typed out, stacked (R,)
    metrics, the store updated in place, equal to the host loop."""
    spec = _spec()
    ds = _quads()
    server = init_server_state(spec, _init())
    store = {"x": torch.zeros(N, DIM)}
    server2, store2, metrics = run_rounds(
        make_grad_fn(quadratic_loss), spec, server, store, 5,
        data=ds.device_data(device="cpu"),
        batch_fn=ds.device_batch_fn(K, 1),
        sample_key=stream_key(0, "cpu"), data_key=stream_key(1, "cpu"))
    assert store2 is store and metrics["loss"].shape == (5,)
    assert metrics["bytes_up"].tolist() == [S * 2 * DIM * 4] * 5
    server_h, stores_h, hist_h = _host_loop(spec, ds, 5)
    _assert_equal(server_h.x, server2.x)
    _assert_equal(stores_h["c_i"], store2)
    assert metrics["loss"].tolist() == [h["loss"] for h in hist_h]
    with pytest.raises(ValueError, match="dict with keys"):
        run_rounds(make_grad_fn(quadratic_loss),
                   _spec(compress="int8_ef"), server, store, 1,
                   data=ds.device_data(device="cpu"),
                   batch_fn=ds.device_batch_fn(K, 1),
                   sample_key=stream_key(0, "cpu"),
                   data_key=stream_key(1, "cpu"))


@pytest.mark.parametrize("spec_kw", [
    dict(server_opt="adam"),
    dict(server_opt="adam", compress="topk_ef", compress_k=2,
         **_solver_kw("momentum")),
], ids=["adam", "adam, topk residuals, momentum slots"])
def test_checkpoint_resume_mid_chunk(tmp_path, spec_kw):
    """Save after 7 rounds (chunks of 5: 5 + 2), restore into a fresh
    trainer, run 5 more: bitwise the unbroken 12 rounds, the restored
    device rows included."""
    spec = _spec(**spec_kw)
    unbroken = _trainer(spec, scan_rounds=5)
    unbroken.run(12)
    a = _trainer(spec, scan_rounds=5)
    a.run(7)
    path = str(tmp_path / "ck.npz")
    save_trainer(path, a)
    b = _trainer(spec, scan_rounds=5)
    load_trainer(path, b)
    assert b.round_idx == 7
    _assert_equal(_families(a), _families(b))
    b.run(5)
    _assert_equal(unbroken.x, b.x)
    _assert_equal(unbroken.c, b.c)
    _assert_equal(unbroken.server.opt_state, b.server.opt_state)
    _assert_equal(_families(unbroken), _families(b))
    assert unbroken.history[7:] == b.history


def test_checkpoint_crosses_engines(tmp_path):
    """A scanned trainer's checkpoint restores into a host-loop trainer
    (the stores synced on save), and a host-loop checkpoint into a
    scanned trainer (the store pushed to the device on restore)."""
    spec = _spec(**_solver_kw("momentum"))
    a = _trainer(spec, scan_rounds=4)
    a.run(4)
    path = str(tmp_path / "scan.npz")
    save_trainer(path, a)
    host = _trainer(spec)
    load_trainer(path, host)
    _assert_equal(a.x, host.x)
    for name, st in host._store_families():
        _assert_equal(_families(a)[name], st.all_rows())
    host.run(2)
    path2 = str(tmp_path / "host.npz")
    save_trainer(path2, host)
    b = _trainer(spec, scan_rounds=4)
    load_trainer(path2, b)
    assert b.round_idx == 6
    _assert_equal(host.x, b.x)
    for name, st in host._store_families():
        _assert_equal(st.all_rows(), _families(b)[name])


def jax_key(path):
    key = jax.random.key(path[0])
    for p in path[1:]:
        key = jax.random.fold_in(key, p)
    return key


def jax_draws(split_base=None, log_bg=None):
    """``streams.injected``'s function: the reference's draw at each of
    the port's paths; the LM's ``(split_base, t, j)`` is the j-th key of
    the reference's three-way split of its round key."""

    def fn(kind, path, shape):
        path, shape = tuple(path), tuple(shape)
        if split_base is not None and path[0] == split_base and len(
                path) == 3:
            key = jax.random.split(jax_key(path[:2]), 3)[path[2]]
        else:
            key = jax_key(path)
        if kind == "permutation":
            return np.asarray(jax.random.permutation(key, shape[0]))
        if kind == "normal":
            return np.asarray(jax.random.normal(key, shape, jnp.float32))
        if kind == "uniform":
            return np.asarray(jax.random.uniform(key, shape))
        return np.asarray(jax.random.categorical(key, log_bg, shape=shape))

    return fn


def _lm_pair(n=6, vocab=64, seq=12):
    jds = JLM(n, vocab_size=vocab, seq_len=seq, seed=0)
    tds = SyntheticLMFederated(n, vocab_size=vocab, seq_len=seq, seed=0)
    return jds, tds, jax_draws(split_base=1,
                               log_bg=jds.device_data()["log_bg"])


@pytest.mark.parametrize("data", ["quadratics", "emnist", "lm"])
def test_device_batch_fn_matches_reference(data):
    """Each dataset's device batch equals the reference's, value for
    value, on the reference's draws."""
    draws = jax_draws()
    if data == "quadratics":
        jds, tds = jax_sim(N, DIM, delta=0.3, G=4.0, mu=0.3, seed=1), _quads()
        k, b = K, 2
    elif data == "emnist":
        jds = JEmnist(num_clients=8, samples=600, similarity_pct=10.0,
                      seed=0, test_samples=50)
        tds = _emnist()[1]
        k, b = 3, 4
    else:
        jds, tds, draws = _lm_pair()
        k, b = 2, 2
    ids = np.array([5, 1, 3])
    jb = jds.device_batch_fn(k, b)(jds.device_data(), jnp.asarray(ids),
                                   jax_key((1, 4)))
    with streams.injected(draws):
        tb = tds.device_batch_fn(k, b)(tds.device_data(device="cpu"),
                                       torch.as_tensor(ids),
                                       stream_key(1, "cpu").fold_in(4))
    assert sorted(jb) == sorted(tb)
    for name, v in jb.items():
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tds.device_client_sizes(device="cpu"),
                                  np.asarray(jds.device_client_sizes()))


def _ref_families(jt):
    store = jax.tree.map(np.asarray, jt.device_store)
    if isinstance(store, dict) and "c_i" in store:
        return {name: flatten_tree(v) for name, v in store.items()}
    return {"c_i": flatten_tree(store)}


def _assert_close(got, want, rtol):
    """Every leaf within ``rtol`` of the leaf's largest magnitude."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].detach().cpu().numpy()
        assert np.abs(g - v).max() <= rtol * max(np.abs(v).max(), 1e-30), k


@functools.lru_cache(maxsize=None)
def _lm_weights():
    cfg = jax_get_reduced("llama3.2-3b")
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))


def _reference_pair(case):
    """(reference trainer, port trainer, rounds, injected draws, rtol)."""
    if case == "quadratics":
        kw = dict(algorithm="scaffold", num_clients=N, num_sampled=S,
                  local_steps=K, local_batch=1, eta_l=0.05, eta_g=0.7,
                  server_optimizer="momentum", server_momentum=0.8,
                  compress="randk_ef", compress_k=2,
                  local_solver="momentum", local_momentum=0.9)
        jt = JTrainer(jax_quadratic_loss,
                      lambda key: {"x": jnp.ones((DIM,), jnp.float32)},
                      JSpec(**kw), jax_sim(N, DIM, delta=0.3, G=4.0, mu=0.3,
                                           seed=1), scan_rounds=3)
        tt = _trainer(TSpec(**kw), scan_rounds=3)
        return jt, tt, 5, jax_draws(), 1e-5
    if case == "emnist":
        kw = dict(algorithm="scaffold", num_clients=8, num_sampled=3,
                  local_steps=3, local_batch=4, eta_l=0.1,
                  weighted_aggregation=True)
        jds = JEmnist(num_clients=8, samples=600, similarity_pct=10.0,
                      seed=0, test_samples=50)
        jt = JTrainer(JS.logreg_loss, lambda key: JS.logreg_init(key, 784, 62),
                      JSpec(**kw), jds, scan_rounds=2)
        _, tds, init = _emnist()
        tt = _trainer(TSpec(**kw), tds, TS.logreg_loss, init, scan_rounds=2)
        return jt, tt, 4, jax_draws(), 1e-5
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05)
    jcfg, tcfg = jax_get_reduced("llama3.2-3b"), get_reduced("llama3.2-3b")
    weights = _lm_weights()
    jds, tds, draws = _lm_pair(4, jcfg.vocab_size, 32)
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, weights),
                  JSpec(**kw), jds, use_fused_update=True, scan_rounds=2)
    tt = _trainer(TSpec(**kw), tds, partial(TM.loss_fn, tcfg),
                  lambda gen: params_from_jax(weights, device="cpu"),
                  scan_rounds=2, use_fused_update=True)
    return jt, tt, 2, draws, 1e-4


@pytest.mark.parametrize("case", ["quadratics", "emnist", "lm"])
def test_scanned_trainer_matches_reference(case):
    """The port's scanned trainer against the reference's, on the
    reference's cohorts and data draws (and randk masks): x, c and every
    store row to 1e-5 of each leaf's scale (the reduced LM 1e-4), the
    losses alike, the byte counts equal."""
    jt, tt, rounds, draws, rtol = _reference_pair(case)
    assert jt.scan_active and tt.scan_active
    jt.run(rounds)
    with streams.injected(draws):
        tt.run(rounds)
    _assert_close(tt.x, flatten_tree(jax.tree.map(np.asarray, jt.x)), rtol)
    _assert_close(tt.c, flatten_tree(jax.tree.map(np.asarray, jt.c)), rtol)
    want = _ref_families(jt)
    got = _families(tt)
    assert sorted(want) == sorted(got)
    for name in want:
        _assert_close(got[name], want[name], rtol)
    for hj, ht in zip(jt.history, tt.history):
        assert (ht["bytes_up"], ht["bytes_down"]) == (hj["bytes_up"],
                                                     hj["bytes_down"])
        assert abs(ht["loss"] - hj["loss"]) <= rtol * abs(hj["loss"])


def test_checkpoint_crosses_packages(tmp_path):
    """A port scanned checkpoint restores into the reference's scanned
    trainer (the same x, c, store rows and device keys), which trains on
    and saves; the port restores that and both run on, alike to 1e-5."""
    kw = dict(algorithm="scaffold", num_clients=N, num_sampled=S,
              local_steps=K, local_batch=1, eta_l=0.05, eta_g=0.7)
    jds = jax_sim(N, DIM, delta=0.3, G=4.0, mu=0.3, seed=1)
    draws = jax_draws()
    tt = _trainer(TSpec(**kw), scan_rounds=2)
    with streams.injected(draws):
        tt.run(3)
    path = str(tmp_path / "port.npz")
    save_trainer(path, tt)
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((DIM,), jnp.float32)},
                  JSpec(**kw), jds, scan_rounds=2)
    jax_load_trainer(path, jt)
    assert jt.round_idx == 3
    _assert_close(tt.x, flatten_tree(jax.tree.map(np.asarray, jt.x)), 0.0)
    for name, rows in _ref_families(jt).items():
        _assert_close(_families(tt)[name], rows, 0.0)
    jt.run(2)
    path2 = str(tmp_path / "ref.npz")
    jax_save_trainer(path2, jt)
    back = _trainer(TSpec(**kw), scan_rounds=2)
    load_trainer(path2, back)
    assert back.round_idx == 5
    _assert_close(back.x, flatten_tree(jax.tree.map(np.asarray, jt.x)), 0.0)
    jt.run(2)
    with streams.injected(draws):
        back.run(2)
    _assert_close(back.x, flatten_tree(jax.tree.map(np.asarray, jt.x)),
                  1e-5)
    for name, rows in _ref_families(jt).items():
        _assert_close(_families(back)[name], rows, 1e-5)


class _HostOnly:
    """A dataset with the host path only."""
    num_clients = N

    def round_batches(self, ids, K, b, rng, device="cuda"):
        return _quads().round_batches(ids, K, b, rng, device=device)


class _Unsized(_HostOnly):
    def device_data(self, device="cuda"):
        return _quads().device_data(device=device)

    def device_batch_fn(self, K, b):
        return _quads().device_batch_fn(K, b)

    def client_sizes(self, ids):
        return np.ones(len(ids))


@pytest.mark.parametrize("ds,weighted,reason", [
    (_HostOnly(), False,
     "dataset _HostOnly has no device-data protocol (device_data()/"
     "device_batch_fn(K, b))"),
    (_Unsized(), True,
     "weighted_aggregation needs _Unsized.device_client_sizes()"),
], ids=["no device protocol", "no device sizes"])
def test_fallback_warns_with_the_reference_reason(ds, weighted, reason):
    """A dataset without the device protocol falls back to the host loop
    with the reference's warning and reason, and runs the host loop's
    trajectory."""
    spec = _spec(weighted_aggregation=weighted)
    with pytest.warns(UserWarning, match="requested but running the host"):
        tr = _trainer(spec, ds, scan_rounds=4, pipeline_depth=0)
    assert not tr.scan_active and tr.scan_fallback_reason == reason
    ref = _trainer(spec)
    for _ in range(3):
        tr.run_round()
        ref.run_round()
    _assert_equal(ref.x, tr.x)


def test_engine_flags():
    """The reference's ValueError for async with scan; pipeline_depth is
    ignored while scanning; the device store's bytes; on the CPU no
    round is captured, and the trainer says why."""
    with pytest.raises(ValueError, match="incompatible with scan_rounds"):
        _trainer(_spec(), scan_rounds=2, async_buffer=2)
    tr = _trainer(_spec(**_solver_kw("adam")), scan_rounds=2,
                  pipeline_depth=3)
    assert tr.scan_active and not tr.scan_captured
    assert tr.scan_graph_reason == "device cpu: CUDA graphs need the card"
    row = DIM * 4 + 2 * DIM * 4 + 4  # c_i, adam's m and v, its step t
    assert tr.client_store_device_bytes() == N * row
    ref = _trainer(_spec(**_solver_kw("adam")), scan_rounds=2)
    tr.run(3)
    ref.run(3)
    _assert_equal(ref.x, tr.x)
    state = tr.host_rng_state()
    assert state["device_sampler"] == streams.key_state(0)
    assert state["device_data_key"] == streams.key_state(1)


def test_launch_tally_counts_replays(monkeypatch):
    """A launch during a capture is recorded on the open tally, not
    counted; each replay adds the tally; a capture with no tally open
    raises."""
    table = {"k": 0}
    plans = {}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with counts.recording() as tally:
        for _ in range(3):
            counts.count(table, "k")
        counts.count(plans, "plan")
    assert table == {"k": 0} and tally.launches() == {"k": 3, "plan": 1}
    with pytest.raises(RuntimeError, match="no launch tally open"):
        counts.count(table, "k")
    plans["plan"] = 0
    tally.replayed()
    tally.replayed(2)
    assert table == {"k": 9} and plans == {"plan": 3}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    counts.count(table, "k")
    assert table == {"k": 10}


def test_draw_ahead_records_serves_and_refuses():
    """A round's draws are recorded once, drawn ahead by their paths into
    rows, and served by the slot; a draw the first round did not make
    raises."""
    ahead = streams.DrawAhead(3, "cpu")
    key = stream_key(7, "cpu")
    with ahead.serving(2):
        first = streams.uniform(key.fold_in(2).fold_in(5), (4,))
    assert ahead.recorded and ahead.round_bytes() == 16
    ahead.allocate()
    ahead.fill(2, 3)
    for r in range(3):
        ahead.slot.fill_(r)
        with ahead.serving(2 + r):
            got = streams.uniform(key.fold_in(99).fold_in(5), (4,))
        want = streams.uniform(key.fold_in(2 + r).fold_in(5), (4,))
        assert torch.equal(got, want)
    assert torch.equal(ahead.bufs[("uniform", (7, 5))][0], first)
    with ahead.serving(2), pytest.raises(RuntimeError, match="did not make"):
        streams.normal(key.fold_in(2), (4,))
