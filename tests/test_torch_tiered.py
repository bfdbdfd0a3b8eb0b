"""The port's tiered population store in the trainer
(``FederatedTrainer(store="tiered")``), its scanned engine
(``core.api.run_rounds_cohort``) and the procedural quadratics, on the
CPU at the reference's small sizes (N 12, S 4, d 5, K 2, 6 rounds).

  * ``ProceduralQuadraticDataset``: the port's host and device batches
    bitwise the reference's numpy batches, and its objective equal;
  * ``run_rounds_cohort`` against the reference's, fed the same global
    cohorts and buffer slots (σ=0 quadratics draw nothing), to 1e-5 of
    each leaf's scale;
  * the tiered host loop against the reference's trainer on the same
    numpy cohorts, to 1e-5 (int8's residual rows of x's scale);
  * tiered bitwise the dense store in the port, across the host,
    pipelined and scanned engines, crossed with scaffold/scaffold_m,
    sgd/adam and none/int8_ef; across gather-ahead depths 1, 2, 4 and
    the memmap and sharded backends; under per-round driving and
    eval-aligned chunks (the prefetch-miss path); with clients resampled
    across chunks (the stale-row repair at ``take``);
  * a tiered resume (memmap) bitwise the unbroken run, in each engine;
  * the device store bounded by the cohort, and a population-scale run;
  * ``--store tiered`` through the entry point.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.core import init_server_state as jax_init_server_state
from repro.core import make_grad_fn as jax_make_grad_fn
from repro.core import run_rounds_cohort as jax_run_rounds_cohort
from repro.data import ProceduralQuadraticDataset as JProcedural
from repro.data import make_similarity_quadratics as jax_sim
from repro.data import quadratic_loss as jax_quadratic_loss
from repro_torch.checkpoint import load_trainer, save_trainer
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree
from repro_torch.core import (
    FederatedTrainer,
    init_server_state,
    make_grad_fn,
    run_rounds_cohort,
)
from repro_torch.core.streams import stream_key
from repro_torch.core.tree import tree_flatten_slots
from repro_torch.data import (
    ProceduralQuadraticDataset,
    make_similarity_quadratics,
    quadratic_loss,
)

N, S, DIM, K = 12, 4, 5, 2
ROUNDS = 6  # scan_rounds=2: 3 chunks, across chunk boundaries
ENGINES = {"host": dict(), "pipelined": dict(pipeline_depth=2),
           "scanned": dict(scan_rounds=2)}
CONFIGS = [(algo, solver, codec) for algo in ("scaffold", "scaffold_m")
           for solver in ("sgd", "adam") for codec in ("none", "int8_ef")]


@functools.lru_cache(maxsize=None)
def _quads():
    return make_similarity_quadratics(N, DIM, delta=0.3, G=8.0, mu=0.3,
                                      seed=0)


def _kw(algo="scaffold", solver="sgd", codec="none"):
    return dict(algorithm=algo, num_clients=N, num_sampled=S, local_steps=K,
                local_batch=1, eta_l=0.1, local_solver=solver, compress=codec)


def _init(gen=None):
    return {"x": torch.ones(DIM)}


def _trainer(config=("scaffold", "sgd", "none"), ds=None, **kw):
    return FederatedTrainer(quadratic_loss, _init, TSpec(**_kw(*config)),
                            ds or _quads(), seed=0, device="cpu", **kw)


def _state(tr):
    """The trainer's whole state, flat: x, c, the optimizer's slots and
    every row family, read through the host stores (which
    ``sync_host_store`` makes whole in every mode)."""
    tr.sync_host_store()
    out = {}
    for name, tree in (("x", tr.x), ("c", tr.c),
                       ("opt", tr.server.opt_state)):
        out.update({f"{name}/{k}": v for k, v in flatten_tree(tree).items()})
    for name, st in tr._store_families():
        out.update({f"{name}/{k}": v for k, v in st.all_rows().items()})
    return out


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _history(tr):
    return [{k: v for k, v in m.items() if k != "round"} for m in tr.history]


def _assert_close(got, want, rtol, scale=None):
    """Every leaf within ``rtol`` of ``scale``, by default the leaf's
    largest magnitude."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].detach().cpu().numpy()
        ref = np.abs(v).max() if scale is None else scale
        assert np.abs(g - v).max() <= rtol * max(ref, 1e-30), k


# -- the procedural quadratics ------------------------------------------------


@pytest.mark.parametrize("n,d,seed", [(N, DIM, 0), (1000, 64, 3),
                                      (1_000_000, 16, 7)])
def test_procedural_batches_are_the_reference_bitwise(n, d, seed):
    ref, port = JProcedural(n, d, seed=seed), ProceduralQuadraticDataset(
        n, d, seed=seed)
    ids = np.random.default_rng(seed).choice(n, size=min(n, 8),
                                             replace=False)
    ids[0] = n - 1
    want = ref.round_batches(ids, K, 3, None)
    host = port.round_batches(ids, K, 3, None, device="cpu")
    dev = port.device_batch_fn(K, 3)(port.device_data(device="cpu"),
                                     torch.from_numpy(ids), None)
    for k in ("A", "b"):
        w = np.asarray(want[k]).view(np.uint32)
        assert np.array_equal(host[k].numpy().view(np.uint32), w), k
        assert np.array_equal(dev[k].numpy().view(np.uint32), w), k
    # A reaches the K-step loop as one (d, d) matrix a client, broadcast
    assert dev["A"].stride()[1] == 0
    x = np.linspace(-1.0, 1.0, d).astype(np.float32)
    assert port.f(x) == ref.f(x)
    assert port.suboptimality({"x": torch.from_numpy(x)}) == \
        ref.suboptimality({"x": x})


# -- the cohort engine against the reference's --------------------------------


@pytest.mark.parametrize("config", [("scaffold", "sgd", "none"),
                                    ("scaffold_m", "adam", "int8_ef")],
                         ids=str)
def test_run_rounds_cohort_matches_the_reference(config):
    """Both engines fed the same (R, S) global cohorts and buffer slots,
    from a cohort buffer of non-zero rows: x, c, every buffer row and the
    losses to 1e-5 of their scale."""
    R = 3
    rng = np.random.default_rng(5)
    round_ids = np.stack([rng.choice(N, size=S, replace=False)
                          for _ in range(R)])
    union, inv = np.unique(round_ids, return_inverse=True)
    slot_ids = inv.reshape(round_ids.shape)
    U = min(N, R * S)
    spec_kw = _kw(*config)
    jspec, tspec = JSpec(**spec_kw), TSpec(**spec_kw)
    jds, tds = jax_sim(N, DIM, delta=0.3, G=8.0, mu=0.3, seed=0), _quads()
    x0 = np.ones(DIM, np.float32)
    fams = {"c_i": {"x": rng.normal(size=(U, DIM)).astype(np.float32)}}
    if config[2] != "none":
        fams["residual"] = {"x": rng.normal(size=(U, DIM)).astype(np.float32)}
    if config[1] == "adam":
        fams["solver"] = {"m/x": rng.normal(size=(U, DIM)).astype(np.float32),
                          "v/x": rng.random((U, DIM)).astype(np.float32),
                          "t": rng.integers(0, 5, U).astype(np.int32)}
    wrapped = len(fams) > 1

    def nest(flat):
        # the reference's slot pytree: {"m": {"x"}, "v": {"x"}, "t"}
        out = {}
        for k, v in flat.items():
            name, _, leaf = k.partition("/")
            if leaf:
                out.setdefault(name, {})[leaf] = jnp.asarray(v)
            else:
                out[name] = jnp.asarray(v)
        return out

    jstore = {name: nest(v) for name, v in fams.items()}
    js, jc, jm = jax_run_rounds_cohort(
        jax_make_grad_fn(jax_quadratic_loss), jspec,
        jax_init_server_state(jspec, {"x": jnp.asarray(x0)}),
        jstore if wrapped else jstore["c_i"], R,
        data=jds.device_data(), batch_fn=jds.device_batch_fn(K, 1),
        round_ids=jnp.asarray(round_ids, jnp.int32),
        slot_ids=jnp.asarray(slot_ids, jnp.int32),
        data_key=jax.random.key(1), comp_key=jax.random.key(2))
    tstore = {name: {k: torch.from_numpy(v.copy()) for k, v in f.items()}
              for name, f in fams.items()}
    ts, tc, tm = run_rounds_cohort(
        make_grad_fn(quadratic_loss), tspec,
        init_server_state(tspec, {"x": torch.from_numpy(x0)}),
        tstore if wrapped else tstore["c_i"], R,
        data=tds.device_data(device="cpu"), batch_fn=tds.device_batch_fn(K, 1),
        round_ids=torch.from_numpy(round_ids),
        slot_ids=torch.from_numpy(slot_ids),
        data_key=stream_key(1, "cpu"), comp_key=stream_key(2, "cpu"))
    assert tc is (tstore if wrapped else tstore["c_i"])  # in place
    _assert_close(ts.x, {"x": np.asarray(js.x["x"])}, 1e-5)
    _assert_close(ts.c, {"x": np.asarray(js.c["x"])}, 1e-5)
    jrows = jax.tree.map(np.asarray, jc if wrapped else {"c_i": jc})
    for name in fams:
        want = flatten_tree(jrows[name])
        if name == "solver":
            want = {k: v.astype(np.float32) for k, v in want.items()}
            got = {k: v.float() for k, v in tstore[name].items()}
        else:
            got = tstore[name]
        _assert_close(got, want, 1e-5)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)


# -- the tiered host loop against the reference's trainer ---------------------


@pytest.mark.parametrize("config", [("scaffold", "sgd", "none"),
                                    ("scaffold_m", "adam", "int8_ef")],
                         ids=str)
def test_tiered_host_loop_matches_the_reference(config):
    """The port's tiered host loop (memmap rows) and the reference's
    trainer draw the same numpy cohorts: x, c and every population row
    to 1e-5 of their scale (int8's residual rows, a rounding error, of
    x's)."""
    jt = JTrainer(jax_quadratic_loss,
                  lambda key: {"x": jnp.ones((DIM,), jnp.float32)},
                  JSpec(**_kw(*config)),
                  jax_sim(N, DIM, delta=0.3, G=8.0, mu=0.3, seed=0))
    tt = _trainer(config, store="tiered", store_backend="memmap")
    jt.run(ROUNDS)
    tt.run(ROUNDS)
    _assert_close(tt.x, {"x": np.asarray(jt.x["x"])}, 1e-5)
    _assert_close(tt.c, {"x": np.asarray(jt.c["x"])}, 1e-5)
    all_ids = np.arange(N)
    for name, st in tt._store_families():
        jst = {"c_i": jt.store, "residual": jt.residual_store,
               "solver": jt.solver_store}[name]
        want = {k: np.asarray(v, np.float32) for k, v in
                flatten_tree(jst.gather(all_ids)).items()}
        # int8's residual is a rounding error, a difference of nearly equal
        # numbers of the model's scale: its error is set by that scale
        _assert_close({k: v.float() for k, v in st.all_rows().items()},
                      want, 1e-5, scale=(float(np.abs(jt.x["x"]).max())
                                         if name == "residual" else None))
    for hj, ht in zip(jt.history, tt.history):
        assert abs(ht["loss"] - hj["loss"]) <= 1e-5 * abs(hj["loss"])
    tt.close()


# -- tiered bitwise the dense store, in the port ------------------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("config", CONFIGS, ids=str)
def test_tiered_equals_dense(config, engine):
    """Server state, every population row family and the metric history,
    bit for bit."""
    dense = _trainer(config, **ENGINES[engine])
    tiered = _trainer(config, store="tiered", **ENGINES[engine])
    assert tiered.scan_active == (engine == "scanned")
    dense.run(ROUNDS)
    tiered.run(ROUNDS)
    assert _history(dense) == _history(tiered)
    _assert_state_equal(_state(dense), _state(tiered))
    tiered.close()
    dense.close()


def test_prefetch_depth_is_invisible():
    """Gather-ahead depth 1, 2 and 4 on the scanned engine: the same
    trajectory (a depth past the run's end is harmless)."""
    runs = []
    for depth in (1, 2, 4):
        tr = _trainer(("scaffold", "adam", "int8_ef"), scan_rounds=2,
                      store="tiered", prefetch_depth=depth)
        tr.run(ROUNDS)
        runs.append((_history(tr), _state(tr)))
        tr.close()
    for hist, state in runs[1:]:
        assert hist == runs[0][0]
        _assert_state_equal(runs[0][1], state)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("store", ["dense", "tiered"])
@pytest.mark.parametrize("backend", ["memmap", "sharded"])
def test_every_backend_is_invisible(backend, store, engine):
    """Under the tiered store or the plain one (whose rows the dense
    scanned engine mirrors), a backend changes no bit."""
    dense = _trainer(**ENGINES[engine])
    tiered = _trainer(store=store, store_backend=backend, **ENGINES[engine])
    dense.run(ROUNDS)
    tiered.run(ROUNDS)
    assert _history(dense) == _history(tiered)
    _assert_state_equal(_state(dense), _state(tiered))
    tiered.close()


def test_per_round_driving_and_eval_chunks():
    """run_round and eval-aligned partial chunks miss the predicted
    prefetch tokens (the synchronous plan and gather) and still equal the
    dense store."""
    dense = _trainer(scan_rounds=4)
    tiered = _trainer(scan_rounds=4, store="tiered")
    eval_fn = lambda p: {"metric": 0.0}  # noqa: E731
    dense.run(3, eval_fn=eval_fn, eval_every=2)
    tiered.run(3, eval_fn=eval_fn, eval_every=2)
    dense.run_round()
    tiered.run_round()
    assert _history(dense) == _history(tiered)
    _assert_state_equal(_state(dense), _state(tiered))
    tiered.close()


def test_resampled_clients_are_repaired_across_chunks(monkeypatch):
    """Consecutive chunks share clients, so a chunk's prefetched rows are
    stale once the previous chunk writes back: ``take`` reads them again
    (counted here) and the run still equals the dense store's."""
    from repro_torch.core import store as tstore

    repaired = []
    real = tstore.refresh_rows

    def counting(prefetched, fresh, stale):
        repaired.append(int(stale.sum()))
        real(prefetched, fresh, stale)

    monkeypatch.setattr(tstore, "refresh_rows", counting)
    dense = _trainer(("scaffold", "sgd", "int8_ef"), scan_rounds=2)
    tiered = _trainer(("scaffold", "sgd", "int8_ef"), scan_rounds=2,
                      store="tiered", prefetch_depth=4)
    dense.run(4 * ROUNDS)
    tiered.run(4 * ROUNDS)
    plans = [tiered._plan_chunk(t, 2) for t in range(0, 4 * ROUNDS, 2)]
    shared = [len(np.intersect1d(a.union, b.union))
              for a, b in zip(plans, plans[1:])]
    assert sum(shared) > 0 and sum(repaired) > 0
    assert _history(dense) == _history(tiered)
    _assert_state_equal(_state(dense), _state(tiered))
    tiered.close()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_tiered_resume_equals_the_unbroken_run(engine, tmp_path):
    """A tiered trainer (memmap rows) saved mid-run and restored into a
    fresh one resumes bit for bit the unbroken dense run."""
    config = ("scaffold_m", "adam", "int8_ef")
    ref = _trainer(config, **ENGINES[engine])
    ref.run(ROUNDS)
    path = str(tmp_path / "ck")
    a = _trainer(config, store="tiered", store_backend="memmap",
                 **ENGINES[engine])
    a.run(ROUNDS // 2 + 1)
    save_trainer(path, a)
    a.close()
    b = _trainer(config, store="tiered", store_backend="memmap",
                 **ENGINES[engine])
    load_trainer(path + ".npz", b)
    b.run(ROUNDS - ROUNDS // 2 - 1)
    assert _history(b) == _history(ref)[ROUNDS // 2 + 1:]
    _assert_state_equal(_state(ref), _state(b))
    b.close()


def test_device_store_is_bounded_by_the_cohort():
    dense = _trainer(scan_rounds=2)
    tiered = _trainer(scan_rounds=2, store="tiered")
    row = tiered.store.row_nbytes
    assert dense.client_store_device_bytes() == N * row
    assert tiered.client_store_device_bytes() == min(N, 2 * S) * row
    assert tiered.client_store_device_bytes(chunk_rounds=5) == N * row
    assert tiered.device_store["x"].shape == (min(N, 2 * S), DIM)
    host = _trainer(store="tiered", pipeline_depth=2)
    assert host.client_store_device_bytes() == 3 * S * row
    tiered.close()
    host.close()


def test_population_scale_run():
    """N = 10^5 procedural clients, tiered: trains, the loss falls, and
    the card would hold only the chunk's cohort rows."""
    n, s, chunk = 100_000, 32, 4
    ds = ProceduralQuadraticDataset(n, 4, seed=3)
    spec = TSpec(algorithm="scaffold", num_clients=n, num_sampled=s,
                 local_steps=2, local_batch=1, eta_l=0.3)
    tr = FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(4)},
                          spec, ds, seed=0, device="cpu", scan_rounds=chunk,
                          store="tiered")
    assert tr.scan_active, tr.scan_fallback_reason
    tr.run(8)
    row = tr.store.row_nbytes
    assert tr.client_store_device_bytes() == chunk * s * row
    assert tr.store.population_nbytes == n * row
    losses = [m["loss"] for m in tr.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    tr.close()


def test_megakernel_gate_takes_procedural_batches():
    """The K-step loop's gate accepts the procedural batches, as the
    reference's does."""
    from repro_torch.core import get_local_solver, megakernel_incompatibility

    ds = ProceduralQuadraticDataset(50, 8, seed=1)
    batches = ds.device_batch_fn(K, 1)(ds.device_data(device="cpu"),
                                       torch.arange(3), None)
    assert megakernel_incompatibility(
        make_grad_fn(quadratic_loss), get_local_solver("sgd"),
        params={"x": torch.ones(8)},
        batches={k: v[0] for k, v in batches.items()}) is None


def test_store_tiered_through_the_entry_point():
    """``--store tiered --store-backend memmap --scan-rounds 2`` trains the
    reduced LM and equals the dense store bitwise."""
    from repro_torch.launch.train import main

    base = ["--preset", "reduced", "--device", "cpu", "--clients", "4",
            "--sampled", "2", "--local-steps", "1", "--local-batch", "1",
            "--seq-len", "16", "--log-every", "2", "--rounds", "2",
            "--scan-rounds", "2"]
    tiered = main(base + ["--store", "tiered", "--store-backend", "memmap",
                          "--prefetch-depth", "1"])
    dense = main(base)
    assert tiered.store_kind == "tiered" and tiered.scan_active
    _assert_state_equal(_state(dense), _state(tiered))
    tiered.close()


def test_slot_rows_flatten_as_the_store_keeps_them():
    """A tiered store keeps the solver's slots as the dense one does: one
    flat family (``m/<leaf>``, ``v/<leaf>``, ``t``)."""
    tr = _trainer(("scaffold", "adam", "none"), store="tiered")
    meta = {"x": torch.empty(DIM, device="meta")}
    want = tree_flatten_slots(tr.local_solver.init(tr.spec, meta))
    assert {k: v[0] for k, v in tr.solver_store.template.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    tr.close()
