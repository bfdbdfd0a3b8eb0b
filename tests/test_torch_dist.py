"""The port's shapes, input specs, distribution layer and ``shard_fn``
against the JAX package's, on the CPU.

  * ``SHAPES``, ``LONG_CONTEXT_ARCHS``, ``supports_shape``,
    ``default_round_spec`` and ``ARCH_IDS`` equal the reference's;
  * ``input_specs`` matches the reference's keys, shapes and dtypes for
    every supported (arch x shape) at published widths, the decode
    cache leaf by leaf on the paths of ``jax.eval_shape(init_cache)``
    (the reference's ``test_input_specs_shapes`` held across packages);
  * every ``partition_*`` tree equals the reference's ``PartitionSpec``
    entries for every leaf of every arch at published widths, on
    shape-only 16x16 and 2x16x16 meshes (the reference test's
    ``FakeMesh``), under both strategies; on a 1x1 ``DeviceMesh`` over a
    one-process gloo group (a ``HashStore``: no network) each reduced
    llama3.2-3b leaf distributes with its placements, and the
    activation constraints redistribute a DTensor;
  * ``shard_fn``: a reduced llama3.2-3b ``federated_round`` and a
    ``run_rounds`` of the quadratics are bitwise equal with an identity
    ``shard_fn`` and without one; a counting ``shard_fn`` sees the
    param tree at each of the reference's points (client_sequential,
    the momentum solver's slots, the codec's residual) and is never
    called under client_parallel;
  * ``sgd_step`` equals the reference's, with and without momentum.

One torch intra-op thread (the suite runs in parallel workers).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist as jdist
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs import SHAPES as J_SHAPES
from repro.configs import default_round_spec as j_round_spec
from repro.configs import get_config as j_get_config
from repro.configs import supports_shape as j_supports
from repro.models import model as JM
from repro.optim import sgd_step as j_sgd_step
from repro_torch import dist as tdist
from repro_torch.configs import (
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    default_round_spec,
    get_config,
    get_reduced,
    supports_shape,
)
from repro_torch.configs.base import FedRoundSpec
from repro_torch.models import model as M
from repro_torch.optim import sgd_step

DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32,
          jnp.dtype("bfloat16"): torch.bfloat16}
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
STRATEGIES = ("client_parallel", "client_sequential")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Shape-only stand-in for the production meshes (no devices), as the
    reference's ``tests/test_dist.py`` has it."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat(tree, is_leaf=None):
    """{path: leaf} of a JAX pytree."""
    return {_path(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _tflat(tree, prefix=""):
    """{path: leaf} of the port's nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# -- configs ------------------------------------------------------------------


def test_shapes_and_arch_ids_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert LONG_CONTEXT_ARCHS == J_LONG
    assert list(SHAPES) == list(J_SHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(
            J_SHAPES[name])


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_supports_shape_and_round_spec_equal_the_reference(arch):
    for name in list(SHAPES) + ["nope"]:
        assert supports_shape(arch, name) == j_supports(arch, name)
    for algo in ("scaffold", "fedavg", "scaffold_m"):
        assert dataclasses.asdict(default_round_spec(arch, algo)) == \
            dataclasses.asdict(j_round_spec(arch, algo))


# -- input specs --------------------------------------------------------------


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    seen = []
    for name, shape in SHAPES.items():
        if not supports_shape(arch, name):
            continue
        seen.append(name)
        spec = default_round_spec(arch) if shape.kind == "train" else None
        jspec = j_round_spec(arch) if shape.kind == "train" else None
        got = _tflat(M.input_specs(cfg, shape, spec))
        want = _flat(JM.input_specs(jcfg, J_SHAPES[name], jspec))
        assert sorted(got) == sorted(want), (name, sorted(got),
                                             sorted(want))
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "meta", (name, k)
            assert tuple(g.shape) == tuple(w.shape), (name, k)
            assert g.dtype == DTYPES[jnp.dtype(w.dtype)], (name, k)
        if shape.kind == "train":
            s, kk, b = spec.num_sampled, spec.local_steps, spec.local_batch
            assert tuple(got["tokens"].shape[:3]) == (s, kk, b)
            assert s * kk * b == shape.global_batch
        elif shape.kind == "decode":
            assert tuple(got["tokens"].shape) == (shape.global_batch, 1)
            assert any(k.startswith("cache/") for k in got)
    assert seen == [n for n in SHAPES if j_supports(arch, n)]


def test_input_specs_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        M.input_specs(get_reduced("llama3.2-3b"), SHAPES["decode_32k"],
                      device="cuda")


# -- partition rules ----------------------------------------------------------


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's partition functions on a shape-only mesh: their
    NamedSharding (which wants real devices) gives back its spec."""
    monkeypatch.setattr(jdist, "NamedSharding", lambda mesh, spec: spec)
    return jdist


def _entries(spec_tree):
    return {k: tuple(v) for k, v in _flat(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    ).items()}


def _tentries(sharding_tree):
    return {k: v.spec for k, v in _tflat(sharding_tree).items()}


def _held(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k] == want[k], (what, k, got[k], want[k])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_partition_specs_equal_the_reference(arch, mesh_name, jax_specs):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mesh = FakeMesh(MESHES[mesh_name])
    x = M.param_tree(cfg, None, torch.device("meta"))
    jx = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    s = 4
    ci = {k: torch.empty((s,) + tuple(v.shape), dtype=v.dtype,
                         device="meta") for k, v in x.items()}
    jci = jax.tree.map(lambda a: jax.ShapeDtypeStruct((s,) + a.shape,
                                                      a.dtype), jx)
    store = {"c_i": ci, "residual": ci}
    jstore = {"c_i": jci, "residual": jci}
    shape = SHAPES["train_4k"]
    batch = M.input_specs(cfg, shape, default_round_spec(arch))
    jbatch = JM.input_specs(jcfg, J_SHAPES["train_4k"], j_round_spec(arch))
    for strategy in STRATEGIES:
        for k, v in x.items():  # the rule itself, leaf by leaf
            lead = 1 if k.startswith("layers/") else 0
            got = tdist.param_partition_spec(k, v.shape, mesh, strategy,
                                             lead_stack_dims=lead)
            want = jdist.param_partition_spec(k, v.shape, mesh, strategy,
                                              lead_stack_dims=lead)
            assert got == tuple(want), (strategy, k)
        _held(_tentries(tdist.partition_params(x, mesh, strategy)),
              _entries(jax_specs.partition_params(jx, mesh, strategy)),
              ("params", strategy))
        _held(_tentries(tdist.partition_client_states(ci, mesh, strategy)),
              _entries(jax_specs.partition_client_states(jci, mesh,
                                                         strategy)),
              ("client states", strategy))
        _held(_tentries(tdist.partition_client_store(store, mesh, strategy)),
              _entries(jax_specs.partition_client_store(jstore, mesh,
                                                        strategy)),
              ("client store", strategy))
        _held(_tentries(tdist.partition_train_batch(batch, mesh, strategy)),
              _entries(jax_specs.partition_train_batch(jbatch, mesh,
                                                       strategy)),
              ("train batch", strategy))
    for name in ("prefill_32k", "decode_32k"):
        specs = M.input_specs(cfg, SHAPES[name])
        jspecs = JM.input_specs(jcfg, J_SHAPES[name])
        for mode in ("data", "model"):
            _held(_tentries(tdist.partition_serve_batch(specs, mesh,
                                                        cache_mode=mode)),
                  _entries(jax_specs.partition_serve_batch(
                      jspecs, mesh, cache_mode=mode)), (name, mode))
    assert tdist.replicated(mesh).spec == tuple(jax_specs.replicated(mesh))


def test_update_space_delta_keys_take_the_stack_rule(jax_specs):
    """A LoRA factor's flat key "layers.0.wq/A" keeps its layer-stack dim
    unsplit, as the reference's rule reads it."""
    mesh = FakeMesh(MESHES["16x16"])
    x = {"layers.0.attn.wq/A": torch.empty((28, 3072, 16), device="meta"),
         "embed/B": torch.empty((16, 128256), device="meta")}
    jx = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
          for k, v in x.items()}
    for strategy in STRATEGIES:
        got = _tentries(tdist.partition_params(x, mesh, strategy))
        want = _entries(jax_specs.partition_params(jx, mesh, strategy))
        _held(got, want, strategy)
        assert got["layers.0.attn.wq/A"][0] is None


@pytest.fixture
def debug_mesh():
    """A 1x1 DeviceMesh over a one-process gloo group (a HashStore),
    destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.dist.activations import set_activation_mesh
    from repro_torch.launch.mesh import make_debug_mesh

    assert not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        set_activation_mesh(None)
        dist.destroy_process_group()


def test_reduced_llama_leaves_distribute_on_a_debug_mesh(debug_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.dist import activations as A

    cfg = get_reduced("llama3.2-3b")
    assert debug_mesh.mesh_dim_names == ("data", "model")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    for strategy in STRATEGIES:
        sh = tdist.partition_params(params, debug_mesh, strategy)
        for k, v in params.items():
            assert sh[k].spec == (None,) * v.dim()
            assert sh[k].placements == (Replicate(), Replicate())
            d = distribute_tensor(v, debug_mesh, sh[k].placements)
            assert isinstance(d, DTensor) and d.placements == sh[k].placements
            assert torch.equal(d.to_local(), v)
    ci = {k: torch.zeros((2,) + tuple(v.shape)) for k, v in params.items()}
    sh = tdist.partition_client_states(ci, debug_mesh, "client_parallel")
    for k, v in ci.items():  # the client axis over "data" (size 1 divides)
        assert sh[k].spec[0] == "data"
        assert sh[k].placements == (Shard(0), Replicate())
        d = distribute_tensor(v, debug_mesh, sh[k].placements)
        assert torch.equal(d.full_tensor(), v)
    # the activation constraints: identity without a mesh, a
    # redistribution of a DTensor with one
    x = torch.randn(2, 8, 16)
    assert A.constrain_batch_dim(x) is x
    A.set_activation_mesh(debug_mesh)
    assert A.get_activation_mesh() is debug_mesh
    assert A.constrain_batch_dim(x) is x  # a plain tensor passes
    dx = distribute_tensor(x, debug_mesh, (Replicate(), Replicate()))
    got = A.constrain_batch_dim(dx)
    assert got.placements == (Shard(0), Replicate())
    assert torch.equal(got.full_tensor(), x)
    got = A.constrain_spec(dx, ("model", "nope", None))
    assert got.placements == (Replicate(), Shard(0))
    # the model's embed runs under the mesh on plain tensors
    tok = torch.randint(0, cfg.vocab_size, (2, 8))
    loss, _ = M.loss_fn(cfg, params, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss)


def test_production_mesh_needs_the_world_and_names_the_dry_run():
    from repro_torch.launch.mesh import make_production_mesh

    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError,
                           match=rf"needs {n} ranks.*repro_torch.launch.dryrun"):
            make_production_mesh(multi_pod=multi_pod)


# -- shard_fn -----------------------------------------------------------------


def _llama_round(strategy, shard_fn):
    from repro_torch.core import federated_round, make_grad_fn

    cfg = get_reduced("llama3.2-3b")
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy=strategy)
    x = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = {k: 0.01 * torch.ones_like(v) for k, v in x.items()}
    ci = {k: torch.zeros((2,) + tuple(v.shape), dtype=v.dtype)
          for k, v in x.items()}
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 1, 32),
                        generator=torch.Generator().manual_seed(1))
    grad_fn = make_grad_fn(partial(M.loss_fn, cfg))
    return federated_round(grad_fn, spec, x, c, ci,
                           {"tokens": tok, "labels": tok},
                           use_fused_update=True, shard_fn=shard_fn)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_identity_shard_fn_is_bitwise_in_the_llama_round(strategy):
    calls = []

    def ident(tree):
        calls.append(1)
        return tree

    a = _llama_round(strategy, None)
    b = _llama_round(strategy, ident)
    for ta, tb in zip(a[:3], b[:3]):
        assert ta.keys() == tb.keys()
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k
    assert torch.equal(a[3]["loss"], b[3]["loss"])
    assert (len(calls) > 0) == (strategy == "client_sequential")


def test_identity_shard_fn_is_bitwise_in_run_rounds_of_the_quadratics():
    from repro_torch.core import (init_server_state, make_grad_fn,
                                  run_rounds, streams)
    from repro_torch.data import make_similarity_quadratics, quadratic_loss

    ds = make_similarity_quadratics(8, 16, delta=0.5, G=1.0, seed=3)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=8, num_sampled=3,
                        local_steps=3, local_batch=2, eta_l=0.05,
                        strategy="client_sequential")
    grad_fn = make_grad_fn(quadratic_loss)
    outs = []
    for shard_fn in (None, lambda t: t):
        server = init_server_state(spec, {"x": torch.zeros(16)})
        store = {"x": torch.zeros((8, 16))}
        out = run_rounds(
            grad_fn, spec, server, store, 3, data=ds.device_data("cpu"),
            batch_fn=ds.device_batch_fn(spec.local_steps, spec.local_batch),
            sample_key=streams.stream_key(0, "cpu"),
            data_key=streams.stream_key(1, "cpu"), shard_fn=shard_fn)
        outs.append(out)
    (sa, sta, ma), (sb, stb, mb) = outs
    assert torch.equal(sa.x["x"], sb.x["x"]) and torch.equal(sa.c["x"],
                                                               sb.c["x"])
    assert torch.equal(sta["x"], stb["x"])
    assert torch.equal(ma["loss"], mb["loss"])


def test_counting_shard_fn_sees_the_param_tree_at_the_reference_points():
    """client_sequential with the momentum solver and int8_ef: per client
    K pins of y and K of the slot m (``run_local_steps``), one of c_i_new,
    one of the residual, one of m (``shard_slots``), and two of the running
    sums; each call gets a tree keyed as x."""
    from repro_torch.core import (ClientRoundState, init_server_state,
                                  make_grad_fn, run_round)
    from repro_torch.data import make_similarity_quadratics, quadratic_loss

    ds = make_similarity_quadratics(6, 8, delta=0.5, G=1.0, seed=3)
    s, k = 3, 4
    for strategy in STRATEGIES:
        spec = FedRoundSpec(algorithm="scaffold", num_clients=6, num_sampled=s,
                            local_steps=k, local_batch=2, eta_l=0.05,
                            local_solver="momentum", compress="int8_ef",
                            strategy=strategy)
        seen = []

        def counting(tree):
            seen.append(sorted(tree))
            return tree

        x = {"x": torch.zeros(8)}
        batches = ds.round_batches(np.arange(s), k, 2,
                                   np.random.default_rng(0), device="cpu")
        run_round(make_grad_fn(quadratic_loss), spec,
                  init_server_state(spec, x),
                  ClientRoundState(c_i={"x": torch.zeros((s, 8))}), batches,
                  use_fused_update=True, shard_fn=counting)
        if strategy == "client_parallel":
            assert seen == []
        else:
            assert len(seen) == s * (2 * k + 5)
            assert all(keys == ["x"] for keys in seen)


# -- sgd_step -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_step_equals_the_reference(dtype, momentum):
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in "ab"}
    g = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in "ab"}
    v = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in "ab"}
    jdt, tdt = jnp.dtype(dtype), DTYPES[jnp.dtype(dtype)]
    jp = {k: jnp.asarray(a, jdt) for k, a in p.items()}
    tp = {k: torch.from_numpy(a).to(tdt) for k, a in p.items()}
    jg = {k: jnp.asarray(a, jdt) for k, a in g.items()}
    tg = {k: torch.from_numpy(a).to(tdt) for k, a in g.items()}
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    tv = {k: torch.from_numpy(a) for k, a in v.items()}
    for vel in (None, "v"):
        jnew, jvel = j_sgd_step(jp, jg, 0.1, momentum=momentum,
                                velocity=jv if vel else None)
        tnew, tvel = sgd_step(tp, tg, 0.1, momentum=momentum,
                              velocity=tv if vel else None)
        for k in p:
            assert tnew[k].dtype == tdt
            assert np.array_equal(tnew[k].float().numpy(),
                                  np.asarray(jnew[k], np.float32)), k
            if vel:
                assert np.array_equal(tvel[k].numpy(), np.asarray(jvel[k]))
            else:
                assert tvel is None and jvel is None
