"""The port's pipelined host loop (``FederatedTrainer(pipeline_depth=d)``)
on the CPU.

  * bitwise the port's synchronous loop at depths 1, 2 and 4, over
    scaffold/scaffold_m, sgd/momentum/adam, none/int8_ef, weighted
    EMNIST logreg and fedavg; the stale-row repair runs (counted);
  * against the reference's pipelined trainer on the same numpy
    cohorts, to 1e-5 of each leaf's scale;
  * ``host_rng_state`` rewound past the prepared rounds, equal to the
    reference's at the same round;
  * a pipelined resume bitwise the unbroken run;
  * ``--pipeline-depth`` through the entry point, bitwise depth 0;
  * ``close`` ends the preparing worker.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import make_similarity_quadratics as jax_sim
from repro.data import quadratic_loss as jax_quadratic_loss
from repro_torch.checkpoint import load_trainer, save_trainer
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree
from repro_torch.core import FederatedTrainer
from repro_torch.data import (
    EmnistLikeFederated,
    make_similarity_quadratics,
    quadratic_loss,
)
from repro_torch.models import simple

N, S, DIM, K = 12, 4, 5, 2
ROUNDS = 6
CASES = {
    "scaffold": dict(algorithm="scaffold"),
    "scaffold int8": dict(algorithm="scaffold", compress="int8_ef"),
    "scaffold_m adam int8": dict(algorithm="scaffold_m", local_solver="adam",
                                 compress="int8_ef"),
    "scaffold momentum": dict(algorithm="scaffold", local_solver="momentum",
                              server_optimizer="adam"),
    "fedavg": dict(algorithm="fedavg"),
}


@functools.lru_cache(maxsize=None)
def _quads():
    return make_similarity_quadratics(N, DIM, delta=0.3, G=8.0, mu=0.3,
                                      seed=0)


def _kw(**change):
    return {**dict(num_clients=N, num_sampled=S, local_steps=K,
                   local_batch=1, eta_l=0.1), **change}


def _trainer(change, **kw):
    return FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(DIM)},
                            TSpec(**_kw(**change)), _quads(), seed=0,
                            device="cpu", **kw)


def _state(tr):
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


@pytest.fixture
def repairs(monkeypatch):
    """How many rows the pipeline's stale-row repair gathered again."""
    from repro_torch.core import controller

    counted = []
    real = controller.refresh_rows

    def counting(prefetched, fresh, stale):
        counted.append(int(stale.sum()))
        real(prefetched, fresh, stale)

    monkeypatch.setattr(controller, "refresh_rows", counting)
    return counted


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_equals_sync(case, depth, repairs):
    sync = _trainer(CASES[case])
    piped = _trainer(CASES[case], pipeline_depth=depth)
    sync.run(ROUNDS)
    piped.run(ROUNDS)
    assert _history(sync) == _history(piped)
    _assert_state_equal(_state(sync), _state(piped))
    # N 12, S 4: consecutive cohorts share clients, whose prepared rows a
    # scatter overwrote (fedavg keeps no client rows: nothing to repair)
    assert (sum(repairs) > 0) == (case != "fedavg")
    piped.close()


def test_pipelined_weighted_emnist_equals_sync():
    data = EmnistLikeFederated(8, 600, 10.0, seed=0, test_samples=50)
    spec = TSpec(algorithm="scaffold", num_clients=8, num_sampled=3,
                 local_steps=3, local_batch=4, eta_l=0.1,
                 weighted_aggregation=True)

    def make(**kw):
        return FederatedTrainer(
            simple.logreg_loss,
            lambda gen: simple.logreg_init(gen, 784, 62, device="cpu"),
            spec, data, seed=0, device="cpu", **kw)

    sync, piped = make(), make(pipeline_depth=2)
    sync.run(4)
    piped.run(4)
    assert _history(sync) == _history(piped)
    _assert_state_equal(_state(sync), _state(piped))
    piped.close()


def _reference(change, depth):
    return JTrainer(jax_quadratic_loss,
                    lambda key: {"x": jnp.ones((DIM,), jnp.float32)},
                    JSpec(**_kw(**change)),
                    jax_sim(N, DIM, delta=0.3, G=8.0, mu=0.3, seed=0),
                    pipeline_depth=depth)


@pytest.mark.parametrize("case", ["scaffold", "scaffold momentum"])
def test_pipelined_matches_the_reference(case):
    """The port's pipelined loop and the reference's draw the same numpy
    cohorts: x, c, every population row and the losses to 1e-5."""
    jt = _reference(CASES[case], 2)
    tt = _trainer(CASES[case], pipeline_depth=2)
    jt.run(ROUNDS)
    tt.run(ROUNDS)
    want = {"x/x": np.asarray(jt.x["x"]), "c/x": np.asarray(jt.c["x"])}
    all_ids = np.arange(N)
    for name, st in (("c_i", jt.store), ("solver", jt.solver_store)):
        if st is not None:
            want.update({f"{name}/{k}": np.asarray(v) for k, v in
                         flatten_tree(st.gather(all_ids)).items()})
    got = {k: v for k, v in _state(tt).items() if not k.startswith("opt/")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].float().numpy()
        assert np.abs(g - v).max() <= 1e-5 * max(np.abs(v).max(), 1e-30), k
    for hj, ht in zip(jt.history, tt.history):
        assert abs(ht["loss"] - hj["loss"]) <= 1e-5 * abs(hj["loss"])
    tt.close()


def test_host_rng_state_is_rewound_as_the_reference():
    """After 3 rounds at depth 2 (rounds 4 and 5 prepared), both packages
    record the RNG states from before round 4 was prepared: what a plain
    trainer holds after 3 rounds."""
    jt, tt = _reference(CASES["scaffold"], 2), _trainer(CASES["scaffold"],
                                                         pipeline_depth=2)
    plain = _trainer(CASES["scaffold"])
    for tr in (jt, tt, plain):
        tr.run(3)
    assert len(tt._prefetch) == 2
    state = tt.host_rng_state()
    assert state == jt.host_rng_state()
    assert state == plain.host_rng_state()
    assert state != tt._rng_state_now()  # the live streams ran ahead
    tt.close()


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_resume_equals_the_unbroken_run(depth, tmp_path):
    case = CASES["scaffold_m adam int8"]
    ref = _trainer(case, pipeline_depth=depth)
    ref.run(ROUNDS)
    path = str(tmp_path / "ck")
    a = _trainer(case, pipeline_depth=depth)
    a.run(ROUNDS // 2)
    save_trainer(path, a)
    a.close()
    b = _trainer(case, pipeline_depth=depth)
    load_trainer(path + ".npz", b)
    b.run(ROUNDS - ROUNDS // 2)
    assert _history(b) == _history(ref)[ROUNDS // 2:]
    _assert_state_equal(_state(ref), _state(b))
    ref.close()
    b.close()


def test_pipeline_depth_through_the_entry_point():
    from repro_torch.launch.train import main

    base = ["--preset", "reduced", "--device", "cpu", "--clients", "4",
            "--sampled", "2", "--local-steps", "1", "--local-batch", "1",
            "--seq-len", "16", "--log-every", "1", "--rounds", "3"]
    piped = main(base + ["--pipeline-depth", "1"])
    sync = main(base)
    assert piped.pipeline_depth == 1
    _assert_state_equal(_state(sync), _state(piped))
    assert _history(sync) == _history(piped)
    piped.close()


def test_close_ends_the_preparing_worker():
    tr = _trainer(CASES["scaffold"], pipeline_depth=2)
    tr.run(2)
    worker = tr._prep_exec
    assert worker is not None and len(tr._prefetch) == 2
    tr.close()
    assert tr._prep_exec is None and not tr._prefetch
    assert all(not t.is_alive() for t in worker._threads)
