"""The port's llama model against the JAX package's: the reduced
llama3.2-3b config in fp32, both started from the same weights (JAX's
init carried across by ``params_from_jax``); ``loss_fn`` and its gradient
(autograd vs ``jax.grad``) agree to rtol 1e-4 per leaf, for the full
cross-entropy and the vocab-chunked one. Every ported architecture's
reduced config inits on the CPU with the analytic count, which equals
the reference's at the published and reduced configs; the architectures
the port refuses are exactly the reference's MoE ones (MLA is ported
with minicpm3-4b).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core.controller import make_grad_fn
from repro_torch.models import model as TM

RTOL = 1e-4
PORTED = ("llama3.2-3b", "gemma3-1b", "mamba2-2.7b", "hymba-1.5b",
          "minitron-4b", "paligemma-3b", "whisper-tiny", "minicpm3-4b")


@pytest.fixture(scope="module")
def weights():
    cfg = jax_get_reduced("llama3.2-3b")
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))


def _batch(seed=0, b=2, s=32, vocab=512):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(b, s + 1)).astype(np.int32)
    toks[0, -3:] = -1  # masked labels
    return toks


@pytest.mark.parametrize("chunk", [0, 200])
def test_loss_and_grad_match_jax(weights, chunk):
    jcfg = dataclasses.replace(jax_get_reduced("llama3.2-3b"),
                               loss_chunk_vocab=chunk)
    tcfg = dataclasses.replace(get_reduced("llama3.2-3b"),
                               loss_chunk_vocab=chunk)
    toks = _batch()
    jb = {"tokens": jnp.asarray(np.maximum(toks[:, :-1], 0)),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(np.maximum(toks[:, :-1], 0)),
          "labels": torch.from_numpy(toks[:, 1:])}
    (lj, mj), gj = jax.value_and_grad(partial(JM.loss_fn, jcfg),
                                      has_aux=True)(
        jax.tree.map(jnp.asarray, weights), jb)
    gt, mt = make_grad_fn(partial(TM.loss_fn, tcfg))(
        params_from_jax(weights, device="cpu"), tb)
    assert abs(float(mt["loss"]) - float(lj)) <= RTOL * abs(float(lj))
    assert float(mt["ntokens"]) == float(mj["ntokens"])
    gj = flatten_tree(jax.tree.map(np.asarray, gj))
    assert sorted(gj) == sorted(gt)
    for k, g in gj.items():
        assert gt[k].shape == g.shape
        assert (np.abs(gt[k].numpy() - g).max()
                <= RTOL * max(np.abs(g).max(), 1e-30)), k


def test_init_layout_matches_jax(weights):
    cfg = get_reduced("llama3.2-3b")
    ours = TM.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    theirs = flatten_tree(weights)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == v.shape, k
        assert str(ours[k].dtype).split(".")[-1] == v.dtype.name, k
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(
        jax_get_reduced("llama3.2-3b"))


def test_full_width_param_count_matches_jax():
    assert (TM.count_params_analytic(get_config("llama3.2-3b"))
            == JM.count_params_analytic(jax_get_config("llama3.2-3b")))


def test_params_from_jax_keeps_bf16_bits():
    a = jax.random.normal(jax.random.key(1), (5, 7), jnp.bfloat16)
    t = params_from_jax({"w": [np.asarray(a)]}, device="cpu")["w/0"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_unported_model_parts_raise():
    # "M" and "Y" layers are ported (tests/test_torch_mamba.py,
    # tests/test_torch_hymba.py), and MLA with minicpm3-4b
    # (tests/test_torch_mla.py); MoE models are not
    cfg = dataclasses.replace(get_reduced("llama3.2-3b"), moe=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TM.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_config("qwen2-moe-a2.7b")


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", PORTED)
def test_every_ported_reduced_config_inits(arch, one_torch_thread):
    cfg = get_reduced(arch)
    assert cfg == TC._ARCHS[arch].reduced() and get_config(arch).name == arch
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert sum(v.numel() for v in params.values()) == \
        TM.count_params_analytic(cfg)
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


@pytest.mark.parametrize("preset", ["full", "reduced"])
@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_jax(arch, preset):
    get = {"full": (get_config, jax_get_config),
           "reduced": (get_reduced, jax_get_reduced)}[preset]
    assert TM.count_params_analytic(get[0](arch)) == \
        JM.count_params_analytic(get[1](arch))


def test_not_ported_is_exactly_mla_and_moe():
    # MLA alone is ported (minicpm3-4b); deepseek-v3 pairs it with MoE
    moe = {a for a in ARCH_IDS if jax_get_config(a).moe is not None}
    assert "deepseek-v3-671b" in moe and "minicpm3-4b" not in moe
    assert set(TC._NOT_PORTED) == moe
    assert set(TC._ARCHS) == set(PORTED) == set(ARCH_IDS) - moe
    for arch in TC._NOT_PORTED:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_reduced(arch)
