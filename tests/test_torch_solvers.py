"""The port's stateful and scheduled local solvers against the JAX
package's: ``run_local_steps`` for ``momentum`` (per-step plain, per-step
fused, and the K-step kernel path; the JAX side in interpret mode), for
``adam`` and for ``sgd_sched`` under each eta schedule, all in fp32 on the
quadratics substrate, y_K, the slots and the mean loss to rtol 1e-5; and
the copied eta tables, which must equal the reference's exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.core import local_solver as jls
from repro.core.controller import make_grad_fn as jax_make_grad_fn
from repro.data import quadratic_loss as jax_quadratic_loss
from repro.kernels.scaffold_update.ops import force_interpret
from repro.optim import schedules as jsched
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.core import local_solver as tls
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import quadratic_loss
from repro_torch.kernels.scaffold_update import ops
from repro_torch.optim import schedules as tsched

RTOL = 1e-5
D, K = 24, 5


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    A = np.broadcast_to(M @ M.T + 0.1 * np.eye(D, dtype=np.float32),
                        (K, 2, D, D)).copy()
    b = rng.standard_normal((K, 2, D)).astype(np.float32)
    y0 = rng.standard_normal(D).astype(np.float32)
    corr = (0.1 * rng.standard_normal(D)).astype(np.float32)
    # slots a client carries in from earlier rounds
    slots = {"m": {"x": rng.standard_normal(D).astype(np.float32)},
             "v": {"x": rng.random(D).astype(np.float32)},
             "t": np.int32(3)}
    return y0, corr, A, b, slots


def _close(got: torch.Tensor, want) -> bool:
    want = np.asarray(want, np.float64)
    return (np.abs(got.double().numpy() - want).max()
            <= RTOL * max(np.abs(want).max(), 1e-30))


def _run_both(solver, path, *, with_corr=True, schedule="", carried=True):
    y0, corr, A, b, slots = _problem()
    kw = dict(algorithm="scaffold", num_clients=2, num_sampled=1,
              local_steps=K, local_batch=2, eta_l=0.1, local_solver=solver,
              eta_l_schedule=schedule, use_megakernel=path == "megakernel")
    keep = {"momentum": ("m",), "adam": ("m", "v", "t")}.get(solver, ())
    if not carried:
        keep = ()
    j_slots = ({k: ({"x": jnp.asarray(slots[k]["x"])} if k != "t"
                    else jnp.asarray(slots[k])) for k in keep}
               if keep else None)
    t_slots = ({k: ({"x": torch.from_numpy(slots[k]["x"].copy())} if k != "t"
                    else torch.tensor(int(slots[k]), dtype=torch.int32))
                for k in keep} if keep else None)
    fused = path != "plain"
    with force_interpret():
        yj, sj, lj = jls.run_local_steps(
            jax_make_grad_fn(jax_quadratic_loss), JSpec(**kw),
            {"x": jnp.asarray(y0)}, {"A": jnp.asarray(A), "b": jnp.asarray(b)},
            slots=j_slots,
            correction={"x": jnp.asarray(corr)} if with_corr else None,
            use_fused_update=fused)
    before = dict(ops.LAUNCHES)
    yt, st, lt = tls.run_local_steps(
        make_grad_fn(quadratic_loss), TSpec(**kw),
        {"x": torch.from_numpy(y0.copy())},
        {"A": torch.from_numpy(A), "b": torch.from_numpy(b)},
        slots=t_slots,
        correction={"x": torch.from_numpy(corr)} if with_corr else None,
        use_fused_update=fused)
    assert ops.LAUNCHES == before  # plain versions on the CPU
    assert _close(yt["x"], yj["x"])
    assert abs(float(lt) - float(lj)) <= RTOL * abs(float(lj))
    return sj, st


@pytest.mark.parametrize("path", ["plain", "fused", "megakernel"])
@pytest.mark.parametrize("with_corr", [True, False])
@pytest.mark.parametrize("carried", [True, False])
def test_momentum_matches_reference(path, with_corr, carried):
    sj, st = _run_both("momentum", path, with_corr=with_corr,
                       carried=carried)
    assert sorted(st) == ["m"] and st["m"]["x"].dtype == torch.float32
    assert _close(st["m"]["x"], sj["m"]["x"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("carried", [True, False])
def test_adam_matches_reference(fused, carried):
    """``use_fused_update`` is only a routing hint: adam has no kernel."""
    sj, st = _run_both("adam", "fused" if fused else "plain",
                       carried=carried)
    assert sorted(st) == ["m", "t", "v"]
    assert _close(st["m"]["x"], sj["m"]["x"])
    assert _close(st["v"]["x"], sj["v"]["x"])
    assert st["t"].dtype == torch.int32 and int(st["t"]) == int(sj["t"])


@pytest.mark.parametrize("schedule", ["constant", "warmup", "cosine"])
@pytest.mark.parametrize("path", ["plain", "megakernel"])
def test_sgd_sched_matches_reference(schedule, path):
    sj, st = _run_both("sgd_sched", path, schedule=schedule)
    np.testing.assert_array_equal(st["eta"].numpy(), np.asarray(sj["eta"]))


def test_sgd_sched_rejects_a_step_count_mismatch():
    spec = TSpec(algorithm="scaffold", num_clients=2, num_sampled=1,
                 local_steps=K + 1, local_batch=2, local_solver="sgd_sched",
                 eta_l_schedule="cosine")
    _, _, A, b, _ = _problem()
    with pytest.raises(AssertionError, match="eta table has 6 steps but the "
                       "batches carry 5 local steps"):
        tls.run_local_steps(make_grad_fn(quadratic_loss), spec,
                            {"x": torch.zeros(D)},
                            {"A": torch.from_numpy(A),
                             "b": torch.from_numpy(b)})


@pytest.mark.parametrize("name", ["constant", "warmup", "cosine"])
@pytest.mark.parametrize("k_steps", [1, 4, 10])
def test_local_eta_table_equals_reference(name, k_steps):
    assert tsched.local_eta_table(name, 0.1, k_steps) == \
        jsched.local_eta_table(name, 0.1, k_steps)


def test_schedule_names_and_unknown_schedule():
    assert tsched.schedule_names() == jsched.schedule_names()
    with pytest.raises(ValueError, match="unknown eta_l schedule"):
        tsched.local_eta_table("linear", 0.1, 4)
    for step in range(12):
        assert tsched.cosine_decay(0.1, 10, warmup=2, floor=0.01)(step) == \
            jsched.cosine_decay(0.1, 10, warmup=2, floor=0.01)(step)
        assert tsched.linear_warmup(0.1, 3)(step) == \
            jsched.linear_warmup(0.1, 3)(step)
