"""The port's registries are open, as the reference's are, and its core
exports the reference's names.

  * an algorithm and a codec registered at run time in both packages
    build a ``FedRoundSpec`` in each and train a round of each, to the
    same x (1e-5);
  * ``repro_torch.core`` exports every name of ``repro.core`` whose
    registry the port has (the list below, the unported ones named);
  * the seed shims ``federated_round`` and ``local_sgd`` agree with the
    reference's;
  * ``repro_torch.configs.base`` holds no frozen tuple of names.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.configs.base as tbase
import repro_torch.core as tcore
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import api as japi
from repro.core import compression as jcomp
from repro.data import make_paper_fig3 as jax_fig3
from repro.data.quadratics import quadratic_loss as jax_quadratic_loss
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.core import api as tapi
from repro_torch.core import compression as tcomp
from repro_torch.data import make_paper_fig3, quadratic_loss

# names of repro.core whose registries or engines the port does not have
# yet: the availability models and the async engine with its staleness
# weightings (A13)
NOT_PORTED = {
    "AsyncBufferedEngine", "AvailabilityModel", "AvailabilityTrace",
    "Dispatch", "DispatchSimulator", "RecordingAvailability",
    "StalenessWeighting", "TraceAvailability", "availability_names",
    "make_availability", "make_staleness_weighting", "record_trace",
    "register_availability", "register_staleness_weighting",
    "staleness_weighting_names",
}
# the names the port exports, each one of repro.core's
EXPORTED = (
    "Algorithm", "ClientRoundState", "ClientSampler", "ClientStateStore",
    "Compressor", "DenseBackend", "DeviceClientSampler", "FederatedTrainer",
    "FullSpace", "HeadOnlySpace", "LoRASpace", "LocalSolver",
    "MemmapBackend", "Privatizer", "RoundOutput", "ServerOptimizer",
    "ServerState", "StoreBackend", "TieredClientStore", "UpdateSpace",
    "algorithm_names", "client_update", "compressor_names",
    "device_sample_ids", "federated_round", "get_algorithm",
    "get_compressor", "get_local_solver", "get_privatizer",
    "get_server_optimizer", "get_update_space", "init_server_state",
    "local_sgd", "local_solver_names", "make_grad_fn", "make_store_backend",
    "privatizer_names", "refresh_rows", "register_algorithm",
    "register_compressor", "register_local_solver", "register_privatizer",
    "register_server_optimizer", "register_store_backend",
    "register_update_space", "resolve_compressor", "resolve_local_solver",
    "resolve_privatizer", "resolve_server_optimizer",
    "resolve_update_space", "round_comm_bytes", "run_local_steps",
    "run_round", "run_rounds", "run_rounds_cohort",
    "server_optimizer_names", "stale_mask", "store_backend_names",
    "update_space_names",
)


def test_core_exports_the_reference_names():
    public = {n for n in dir(jcore) if not n.startswith("_")
              and not isinstance(getattr(jcore, n), type(jcore))}
    assert set(EXPORTED) | NOT_PORTED == public
    assert not set(EXPORTED) & NOT_PORTED
    for name in EXPORTED:
        assert hasattr(tcore, name), name


def test_spec_module_holds_no_name_tuples():
    tuples = [n for n, v in vars(tbase).items()
              if isinstance(v, tuple) and v and all(isinstance(s, str)
                                                    for s in v)]
    assert tuples == []


def _pair(**kw):
    spec = {**dict(algorithm="scaffold", num_clients=2, num_sampled=2,
                   local_steps=5, local_batch=1, eta_l=0.1), **kw}
    jds, tds = jax_fig3(G=10.0), make_paper_fig3(G=10.0)
    jt = jcore.FederatedTrainer(
        jax_quadratic_loss,
        lambda key: {"x": jnp.ones((jds.dim,), jnp.float32)},
        JSpec(**spec), jds)
    tt = tcore.FederatedTrainer(quadratic_loss,
                                lambda gen: {"x": torch.ones(tds.dim)},
                                TSpec(**spec), tds, device="cpu")
    return jt, tt


@pytest.fixture
def registered():
    """A SCAFFOLD twin and an identity codec, registered in both
    packages for the test and removed after it."""

    class JTwin(japi.Scaffold):
        name = "scaffold_twin_test"

    class TTwin(tapi.Scaffold):
        name = "scaffold_twin_test"

    class JCodec(jcomp.NoCompression):
        name = "identity_test"

    class TCodec(tcomp.NoCompression):
        name = "identity_test"

    jcore.register_algorithm(JTwin())
    tcore.register_algorithm(TTwin())
    jcore.register_compressor(JCodec())
    tcore.register_compressor(TCodec())
    try:
        yield
    finally:
        del japi._ALGORITHMS["scaffold_twin_test"]
        del tapi._ALGORITHMS["scaffold_twin_test"]
        del jcomp._COMPRESSORS["identity_test"]
        del tcomp._COMPRESSORS["identity_test"]


def test_a_registered_algorithm_and_codec_build_a_spec_and_train(registered):
    with pytest.raises(AssertionError):
        TSpec(algorithm="nope", num_clients=2, num_sampled=2, local_steps=1,
              local_batch=1)
    for kw in (dict(algorithm="scaffold_twin_test"),
               dict(compress="identity_test")):
        spec = {**dict(algorithm="scaffold", num_clients=2, num_sampled=2,
                       local_steps=1, local_batch=1), **kw}
        assert TSpec(**spec) and JSpec(**spec)
        jt, tt = _pair(**kw)
        for _ in range(2):
            mj, mt = jt.run_round(), tt.run_round()
            assert mt["bytes_up"] == mj["bytes_up"]
        want = np.asarray(jt.server.x["x"])
        assert np.abs(tt.x["x"].numpy() - want).max() <= 1e-5 * np.abs(
            want).max()


@pytest.mark.parametrize("algo", ["scaffold", "fedavgm"])
def test_federated_round_matches_the_reference(algo):
    kw = dict(algorithm=algo, num_clients=2, num_sampled=2, local_steps=5,
              local_batch=1, eta_l=0.1)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jds, tds = jax_fig3(G=10.0), make_paper_fig3(G=10.0)
    ids = np.array([1, 0])
    rng = np.random.default_rng(0)
    c_i = rng.standard_normal((2, jds.dim)).astype(np.float32)
    c = rng.standard_normal(jds.dim).astype(np.float32)
    x = np.ones(jds.dim, np.float32)
    mom = (0.1 * rng.standard_normal(jds.dim)).astype(np.float32)
    jm = {"x": jnp.asarray(mom)} if algo == "fedavgm" else None
    tm = {"x": torch.from_numpy(mom.copy())} if algo == "fedavgm" else None
    jout = jcore.federated_round(
        jcore.make_grad_fn(jax_quadratic_loss), jspec, {"x": jnp.asarray(x)},
        {"x": jnp.asarray(c)}, {"x": jnp.asarray(c_i)},
        jds.round_batches(ids, 5, 1, None), momentum=jm)
    tout = tcore.federated_round(
        tcore.make_grad_fn(quadratic_loss), tspec,
        {"x": torch.from_numpy(x.copy())}, {"x": torch.from_numpy(c.copy())},
        {"x": torch.from_numpy(c_i.copy())},
        tds.round_batches(ids, 5, 1, None, device="cpu"), momentum=tm)
    assert len(tout) == len(jout) == (5 if algo == "fedavgm" else 4)
    for a, b in zip(tout[:-1], jout[:-1]):
        want = np.asarray(b["x"])
        assert np.abs(a["x"].numpy() - want).max() <= 1e-5 * max(
            np.abs(want).max(), 1e-30)
    assert tout[-1]["bytes_up"] == int(jout[-1]["bytes_up"])


def test_local_sgd_matches_the_reference():
    jds, tds = jax_fig3(G=10.0), make_paper_fig3(G=10.0)
    ids = np.array([0])
    rng = np.random.default_rng(1)
    corr = rng.standard_normal(jds.dim).astype(np.float32)
    jb = {k: v[0] for k, v in jds.round_batches(ids, 4, 1, None).items()}
    tb = {k: v[0] for k, v in tds.round_batches(ids, 4, 1, None,
                                                device="cpu").items()}
    jy, jl = jcore.local_sgd(jcore.make_grad_fn(jax_quadratic_loss),
                             {"x": jnp.ones(jds.dim)}, jb, 0.1,
                             correction={"x": jnp.asarray(corr)})
    ty, tl = tcore.local_sgd(tcore.make_grad_fn(quadratic_loss),
                             {"x": torch.ones(tds.dim)}, tb, 0.1,
                             correction={"x": torch.from_numpy(corr)})
    want = np.asarray(jy["x"])
    assert np.abs(ty["x"].numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
