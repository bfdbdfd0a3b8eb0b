"""The port's multi-head latent attention (MLA) and minicpm3-4b against
the JAX package's, on the CPU.

  * ``MLAConfig`` is a field-for-field copy, defaults included, and the
    minicpm3-4b config (full and reduced) too;
  * the published config's leaf paths, shapes and dtypes on the meta
    device equal the reference's ``jax.eval_shape(init_params)``, and
    ``count_params_analytic`` equals the reference's at both presets;
  * ``dense_attention`` and ``flash_attention`` with q/k head dim 96 and
    v head dim 64 (MLA's) and the explicit ``1/sqrt(nope + rope)``
    scale, against the reference's, to 1e-5 of the largest element;
  * the reduced minicpm3 from the JAX package's weights: loss to 1e-5
    relative and every gradient leaf to 1e-4 of its largest element,
    with the full logits and with the streaming CE;
  * ``mla_block`` past 2048 tokens (its flash path) against the
    reference's;
  * the default LoRA targets skip MLA's factored projections: the
    port's selection equals the reference's ``leaf_paths`` selection;
  * two SCAFFOLD trainer rounds, full space and LoRA (the reference's
    init draws injected), against the JAX trainer's host loop.

The decode side (``mla_decode`` and its latent cache) is held in
``tests/test_torch_decode.py``.
"""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedRoundSpec as JSpec
from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import FederatedTrainer as JTrainer
from repro.core import update_space as JU
from repro.data import SyntheticLMFederated as JLM
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.configs.base import MLAConfig
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.core import FederatedTrainer, streams
from repro_torch.core import update_space as TU
from repro_torch.data import SyntheticLMFederated
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from test_torch_minitron import (
    _close,
    assert_config_is_a_copy,
    assert_layout_matches_jax,
    assert_loss_and_grads_match,
    jax_weights,
)
from test_torch_update_space import assert_trainers_agree, jax_draws

ARCH = "minicpm3-4b"


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
    return jax_weights(ARCH)


def test_mla_config_is_a_field_for_field_copy():
    jf = [(f.name, f.default) for f in dataclasses.fields(JMLAConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(MLAConfig)]
    assert jf == tf
    assert dataclasses.asdict(jax_get_config(ARCH).mla) == \
        dataclasses.asdict(get_config(ARCH).mla)


def test_config_is_a_copy():
    assert_config_is_a_copy(ARCH)
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == \
        (62, 2560, 40, 73448)
    assert (cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank,
            cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim,
            cfg.mla.v_head_dim) == (768, 256, 64, 32, 64)


def test_full_config_layout_and_count_match_jax():
    got = assert_layout_matches_jax(ARCH)
    assert got["layers/0/attn/wq_b"].shape == (62, 768, 40 * 96)
    assert got["layers/0/attn/kv_norm/scale"].shape == (62, 256)
    assert "layers/0/attn/wq" not in got


@pytest.mark.parametrize("preset", ["full", "reduced"])
def test_param_count_matches_jax(preset):
    get = {"full": (get_config, jax_get_config),
           "reduced": (get_reduced, jax_get_reduced)}[preset]
    assert TM.count_params_analytic(get[0](ARCH)) == \
        JM.count_params_analytic(get[1](ARCH))


def _qkv(rng, b, s, h, dqk, dv):
    q = rng.standard_normal((b, s, h, dqk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dqk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mask", ["causal", "prefix"])
@pytest.mark.parametrize("kind", ["dense", "flash"])
def test_attention_takes_mla_head_dims(kind, mask):
    """q/k 96 wide (nope 64 + rope 32), v 64 wide, the scale given."""
    q, k, v = _qkv(np.random.default_rng(0), 2, 256, 4, 96, 64)
    scale = 1.0 / math.sqrt(96)
    kw = dict(mask_kind=mask, prefix_len=40 if mask == "prefix" else 0,
              scale=scale)
    if kind == "flash":
        want = JL.flash_attention_jnp(*map(jnp.asarray, (q, k, v)),
                                      block_kv=64, **kw)
        got = L.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                block_kv=64, **kw)
    else:
        want = JL.dense_attention(*map(jnp.asarray, (q, k, v)), **kw)
        got = L.dense_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (2, 256, 4, 64)
    _close(got, np.asarray(want), 1e-5, kind)


@pytest.mark.parametrize("chunk", [0, 200], ids=["logits", "chunked-ce"])
def test_loss_and_grads_match_jax(weights, chunk):
    assert_loss_and_grads_match(ARCH, weights, 48, loss_chunk_vocab=chunk)


def test_mla_block_flash_path_matches_jax(weights):
    """Past ``FLASH_THRESHOLD`` tokens ``mla_block`` takes
    ``flash_attention`` (a kv block of 1024 needs S a multiple of it)."""
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    s = 3072
    assert s > L.FLASH_THRESHOLD
    jp = jax.tree.map(jnp.asarray, weights["layers"][0]["attn"])
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = {k: v[0] for k, v in params_from_jax(
        weights["layers"][0]["attn"], device="cpu").items()}
    x = np.random.default_rng(4).standard_normal(
        (1, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)[None]
    want = JL.mla_block(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = L.mla_block(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, np.asarray(want), 1e-5, "mla_block flash")


def test_default_lora_targets_skip_mla_projections(weights):
    spec = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
                local_steps=2, local_batch=1, update_space="lora",
                lora_rank=4)
    jhits = [p for p, _ in JU.get_update_space("lora").targets(
        JSpec(**spec), jax.tree.map(jnp.asarray, weights))]
    thits = [p for p, _ in TU.get_update_space("lora").targets(
        TSpec(**spec), params_from_jax(weights, device="cpu"))]
    assert thits == jhits
    assert [p for p, _ in TU.leaf_paths(params_from_jax(
        weights, device="cpu"))] == [p for p, _ in JU.leaf_paths(weights)]
    names = {p.rsplit(".", 1)[-1] for p in thits}
    assert names == {"wo", "w_gate", "w_up", "w_down"}


@pytest.mark.parametrize("space", ["full", "lora"])
def test_trainer_rounds_match_jax(weights, space):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05)
    if space == "lora":
        kw.update(update_space="lora", lora_rank=4)
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, weights), JSpec(**kw),
                  JLM(4, jcfg.vocab_size, 32), seed=0, use_fused_update=True)
    with streams.injected(jax_draws):
        tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                              lambda gen: params_from_jax(weights,
                                                          device="cpu"),
                              TSpec(**kw), SyntheticLMFederated(
                                  4, tcfg.vocab_size, 32), seed=0,
                              use_fused_update=True, device="cpu")
    for _ in range(2):
        mj, mt = jt.run_round(), tt.run_round()
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
        assert int(mt["bytes_up"]) == int(mj["bytes_up"])
    assert_trainers_agree(jt, tt, 1e-4)
    got = tt.eval_params()
    assert sorted(got) == sorted(flatten_tree(weights))
