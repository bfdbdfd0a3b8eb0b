"""The port's routed mixture of experts, qwen2-moe-a2.7b and
deepseek-v3-671b against the JAX package's, on the CPU, from the
reference's weights (``params_from_jax``).

  * ``MoEConfig`` is a field-for-field copy, defaults included, and both
    architectures' configs (full and reduced) too; the published
    configs' leaf paths, shapes and dtypes on the meta device equal the
    reference's ``jax.eval_shape(init_params)`` (so ``params_from_jax``
    carries every MoE leaf across by its path);
  * ``init_moe``: leaves, shapes and dtypes (fp32 and bf16), and the
    fan-in of the stacked expert matrices;
  * ``_router``: the top-k ids equal, weights to 1e-6, aux to rtol 1e-5;
  * each dispatch against the reference's same one (rtol 2e-4, atol
    2e-5, the bounds of the reference's ``tests/test_moe.py``), the ids
    asserted equal first, so a routing flip shows as a flip; gshard at
    the configs' capacity factor, where tokens are dropped, with the kept
    assignments equal to the reference's;
  * ragged against gshard at capacity factor 8 (no drops);
  * both dispatches' gradients, finite and against ``jax.grad`` within
    1e-4 of each leaf's largest element;
  * the reduced models' loss (with ``router_aux_coef`` times the summed
    aux) and gradients, under either dispatch, with the logits and with
    the streaming CE; one ``federated_round`` each;
  * LoRA on the stacked 4-D expert leaves (L, E, d, f): the deltas'
    keys, shapes and the reference's draws bitwise, ``apply`` and
    ``grad_project`` against the reference's, and two trainer rounds.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import update_space as JU
from repro.data import SyntheticLMFederated as JLM
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core import FederatedTrainer, streams
from repro_torch.core import update_space as TU
from repro_torch.data import SyntheticLMFederated
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from test_torch_minitron import (
    _close,
    assert_config_is_a_copy,
    assert_federated_round_matches,
    assert_layout_matches_jax,
    assert_loss_and_grads_match,
    jax_weights,
)
from test_torch_update_space import assert_trainers_agree, jax_draws

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models are small: one intra-op thread keeps them from
    oversubscribing the cores when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return {arch: jax_weights(arch) for arch in ARCHS}


def _block(arch, tokens=64, seed=0, skew=0.0):
    """The reduced config's MoE leaves from the reference's init (numpy),
    and a seeded (2, tokens / 2, d) input; ``skew`` adds that multiple of
    the unit vector along expert 0's router column to every token, so
    that most of them pick expert 0 (the GShard dispatch then drops)."""
    cfg = jax_get_reduced(arch)
    p = jax.tree.map(np.asarray, JL.init_moe(cfg, jax.random.key(seed),
                                             jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, tokens // 2, cfg.d_model)).astype(np.float32)
    r0 = p["router"][:, 0]
    x = (x + skew * r0 / np.linalg.norm(r0)).astype(np.float32)
    return jax_get_reduced(arch), get_reduced(arch), p, x


def test_moe_config_is_a_field_for_field_copy():
    jf = [(f.name, f.default) for f in dataclasses.fields(JMoEConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(MoEConfig)]
    assert jf == tf
    for arch in ARCHS:
        assert dataclasses.asdict(jax_get_config(arch).moe) == \
            dataclasses.asdict(get_config(arch).moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy(arch):
    assert_config_is_a_copy(arch)
    assert get_reduced(arch).moe_impl == "gshard"
    assert get_config(arch).moe_impl == "ragged"


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_layout_matches_jax(arch):
    got = assert_layout_matches_jax(arch)
    if arch == "qwen2-moe-a2.7b":
        assert got["layers/0/moe/w_gate"].shape == (24, 60, 2048, 1408)
        assert got["layers/0/moe/shared/w_down"].shape == (24, 4 * 1408,
                                                           2048)
    else:
        # 3 dense layers of width 18432, then 58 MoE layers, MLA in all
        assert got["layers/0/mlp/w_up"].shape == (3, 7168, 18432)
        assert got["layers/1/moe/w_down"].shape == (58, 256, 2048, 7168)
        assert got["layers/1/moe/router"].shape == (58, 7168, 256)
        assert got["layers/1/attn/wkv_a"].shape == (58, 7168, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_dtypes(arch, dtype):
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    want = flatten_tree(jax.eval_shape(
        lambda: JL.init_moe(jcfg, jax.random.key(0), getattr(jnp, dtype))))
    got = L.init_moe(tcfg, torch.Generator().manual_seed(0),
                     getattr(torch, dtype), "cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == v.dtype.name, k
    # the experts' fan-in is their middle axis: std 1/sqrt(d) and
    # 1/sqrt(f), the router's 0.02
    f = tcfg.moe.expert_d_ff
    for k, std in (("w_gate", tcfg.d_model ** -0.5), ("w_down", f ** -0.5),
                   ("router", 0.02)):
        assert abs(float(got[k].float().std()) / std - 1) < 0.05, k


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    jcfg, tcfg, p, x = _block(arch)
    xf = x.reshape(-1, jcfg.d_model)
    jw, jids, jaux = JL._router(jcfg, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(xf))
    tw, tids, taux = L._router(tcfg, params_from_jax(p, device="cpu"),
                               torch.from_numpy(xf))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, np.asarray(jw), 1e-6, "weights")
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _jax_keep(cfg, ids, cap):
    """The reference's kept assignments of one token group (its
    ``moe_block_gshard.per_group``, which does not return them)."""
    onehot = jax.nn.one_hot(ids, cfg.moe.num_experts, dtype=jnp.float32)
    gsz, kk, ex = onehot.shape
    oh_flat = onehot.reshape(gsz * kk, ex)
    pos_flat = jnp.cumsum(oh_flat, axis=0) - oh_flat
    pos = jnp.einsum("ge,ge->g", pos_flat, oh_flat).reshape(gsz, kk)
    return np.asarray(pos < cap)


@pytest.mark.parametrize("arch", ARCHS)
def test_gshard_kept_assignments_equal_jax(arch):
    """At the configs' capacity factor 1.25 a group of 64 tokens has 40
    slots an expert for its 128 assignments; with the tokens skewed
    towards expert 0 some are dropped, the same ones in both
    packages."""
    jcfg, tcfg, p, x = _block(arch, skew=8.0)
    xf = x.reshape(-1, jcfg.d_model)
    _, jids, _ = JL._router(jcfg, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(xf))
    _, tids, _ = L._router(tcfg, params_from_jax(p, device="cpu"),
                           torch.from_numpy(xf))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    g, cap = L._gshard_groups(tcfg, xf.shape[0], tcfg.moe.capacity_factor,
                              tcfg.moe.gshard_group_size)
    assert (g, cap) == (64, 40)
    _, _, keep = L.gshard_keep(tcfg, tids, cap)
    want = _jax_keep(jcfg, jids, cap)
    np.testing.assert_array_equal(keep.numpy().astype(bool), want)
    assert 0 < int((~want).sum())


@pytest.mark.parametrize("impl", ["ragged", "gshard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_jax(arch, impl):
    """gshard with the tokens skewed, so that it drops."""
    jcfg, tcfg, p, x = _block(arch, skew=8.0 if impl == "gshard" else 0.0)
    jfn = JL.moe_block_ragged if impl == "ragged" else JL.moe_block_gshard
    tfn = L.moe_block_ragged if impl == "ragged" else L.moe_block_gshard
    jo, ja = jfn(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    to, ta = tfn(tcfg, params_from_jax(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_equals_gshard_without_drops(arch):
    _, tcfg, p, x = _block(arch, skew=8.0)
    tp, tx = params_from_jax(p, device="cpu"), torch.from_numpy(x)
    out_r, aux_r = L.moe_block_ragged(tcfg, tp, tx)
    out_g, aux_g = L.moe_block_gshard(tcfg, tp, tx, capacity_factor=8.0)
    np.testing.assert_allclose(out_r.numpy(), out_g.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux_r), float(aux_g), rtol=1e-5)
    # the dispatch drops at the configs' own factor: the outputs part
    out_d, _ = L.moe_block_gshard(tcfg, tp, tx)
    assert float((out_d - out_r).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["ragged", "gshard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_grads_match_jax(arch, impl):
    """d(sum(out^2) + aux) by every leaf and by x."""
    jcfg, tcfg, p, x = _block(arch, tokens=32)

    def jloss(pp, xx):
        out, aux = JL.moe_block(jcfg, pp, xx, impl=impl)
        return jnp.sum(out ** 2) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                              jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_jax(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = L.moe_block(tcfg, tp, tx, impl=impl)
    loss = torch.sum(out ** 2) + aux
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    want = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(tp)
    for (k, _), g in zip(tp.items(), grads):
        assert bool(torch.isfinite(g).all()), k
        _close(g, want[k], 1e-4, k)
    _close(grads[-1], np.asarray(jgx), 1e-4, "x")


@pytest.mark.parametrize("chunk", [0, 200], ids=["logits", "chunked-ce"])
@pytest.mark.parametrize("impl", ["gshard", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(weights, arch, impl, chunk):
    assert_loss_and_grads_match(arch, weights[arch], 48, moe_impl=impl,
                                loss_chunk_vocab=chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_adds_the_router_aux(weights, arch):
    """loss_fn = cross-entropy + router_aux_coef * the summed aux: with
    the coefficient at 0 the loss drops by exactly the aux term."""
    cfg = get_reduced(arch)
    params = params_from_jax(weights[arch], device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        with_aux, _ = TM.loss_fn(cfg, params, batch)
        _, aux = TM.forward(cfg, params, batch)
        plain = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_aux_coef=0.0))
        without, _ = TM.loss_fn(plain, params, batch)
    n_moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.num_layers))
    assert n_moe == (2 if arch == "qwen2-moe-a2.7b" else 1)
    assert float(aux) > 0.9 * n_moe
    # the difference of two fp32 losses: within 2 ulp of the loss
    ulp = float(np.finfo(np.float32).eps) * float(with_aux)
    assert abs(float(with_aux - without)
               - cfg.moe.router_aux_coef * float(aux)) <= 2 * ulp


@pytest.mark.parametrize("arch", ARCHS)
def test_federated_round_matches_jax(weights, arch):
    assert_federated_round_matches(arch, weights[arch])


LORA = dict(update_space="lora", lora_rank=4, lora_alpha=8.0,
            update_targets="")


def _lora_pair(weights):
    """Both packages' LoRA spaces on the reduced qwen2-moe at the default
    targets, the reference's deltas at key 4 and the port's from the same
    draws (``streams.injected``), the B factors then moved off zero by
    one numpy draw."""
    base = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
                local_steps=2, local_batch=1, **LORA)
    jspec, tspec = JSpec(**base), TSpec(**base)
    jsp, tsp = JU.get_update_space("lora"), TU.get_update_space("lora")
    w = weights["qwen2-moe-a2.7b"]
    jbase = jax.tree.map(jnp.asarray, w)
    tbase = params_from_jax(w, device="cpu")
    jd = jsp.init_deltas(jspec, jbase, jax.random.key(4))
    with streams.injected(jax_draws):
        td = tsp.init_deltas(tspec, tbase, streams.stream_key(4, "cpu"))
    flat = flatten_tree(jax.tree.map(np.asarray, jd))
    rng = np.random.default_rng(1)
    moved = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                 if k.endswith("/B") else v) for k, v in flat.items()}
    jd_moved = {}
    for k, v in moved.items():
        path, fac = k.rsplit("/", 1)
        jd_moved.setdefault(path, {})[fac] = jnp.asarray(v)
    td_moved = {k: torch.from_numpy(moved[k].copy()) for k in td}
    return (jsp, jspec, jbase, jd_moved), (tsp, tspec, tbase, td, td_moved,
                                           flat)


def test_lora_on_expert_leaves_matches_jax(weights):
    (jsp, jspec, jbase, jd), (tsp, tspec, tbase, td0, td, flat) = \
        _lora_pair(weights)
    assert sorted(td0) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(td0[k].numpy(), v, err_msg=k)
    # the 4-D expert leaves (L, E, d, f) carry (L, E, d, r) x (L, E, r, f)
    a = td0["layers.0.moe.w_gate/A"]
    assert a.shape == (2, 4, 256, 4)
    assert td0["layers.0.moe.w_down/B"].shape == (2, 4, 4, 256)
    assert "layers.0.moe.shared.w_up/A" in td0
    assert not any(k.startswith("layers.0.moe.router") for k in td0)
    merged = tsp.apply(tspec, tbase, td)
    want = flatten_tree(jax.tree.map(np.asarray, jsp.apply(jspec, jbase, jd)))
    assert sorted(merged) == sorted(want)
    for k, v in want.items():
        _close(merged[k], v, 1e-5, k)
    rng = np.random.default_rng(2)
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in want.items()}
    jg = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(g["/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)]),
        jbase)
    got = tsp.grad_project(tspec, tbase, td,
                           {k: torch.from_numpy(v) for k, v in g.items()})
    want = flatten_tree(jax.tree.map(np.asarray, jsp.grad_project(
        jspec, jbase, jd, jg)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, 1e-5, k)


def test_lora_trainer_rounds_match_jax(weights):
    arch = "qwen2-moe-a2.7b"
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05, **LORA)
    w = weights[arch]
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, w), JSpec(**kw),
                  JLM(4, jcfg.vocab_size, 32), seed=0, use_fused_update=True)
    with streams.injected(jax_draws):
        tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                              lambda gen: params_from_jax(w, device="cpu"),
                              TSpec(**kw), SyntheticLMFederated(
                                  4, tcfg.vocab_size, 32), seed=0,
                              use_fused_update=True, device="cpu")
    for _ in range(2):
        mj, mt = jt.run_round(), tt.run_round()
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
        assert int(mt["bytes_up"]) == int(mj["bytes_up"])
    assert_trainers_agree(jt, tt, 1e-4)


def test_grouped_mm_plain_route_and_refusals():
    """On the CPU ``grouped_mm`` is the plain version: one ``@`` a group,
    rows past the last end zero, differentiable; the CUDA wrappers refuse
    CPU tensors, and a malformed call raises."""
    from repro_torch.kernels.grouped_mm import (
        grouped_mm,
        grouped_mm_cuda,
        grouped_mm_wgrad_cuda,
    )

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((10, 6), generator=gen, requires_grad=True)
    b = torch.randn((3, 6, 5), generator=gen, requires_grad=True)
    ends = torch.tensor([4, 4, 9], dtype=torch.int32)
    out = grouped_mm(a, b, ends)
    want = torch.cat([a[:4] @ b[0], a[4:9] @ b[2], torch.zeros(1, 5)])
    assert torch.equal(out, want)
    out.sum().backward()
    assert not b.grad[1].any() and not a.grad[9].any()
    for call in (lambda: grouped_mm_cuda(a, b, ends),
                 lambda: grouped_mm_wgrad_cuda(a, out, ends)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(TypeError, match="int32"):
        grouped_mm(a, b, ends.long())
    with pytest.raises(ValueError):
        grouped_mm(a, b[:2], ends)
