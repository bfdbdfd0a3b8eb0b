"""The port's prefix LM (paligemma-3b) against the JAX package's, on the
CPU.

  * the config (full and reduced) is a field-for-field copy;
  * the published config's leaf layout on the meta device equals the
    reference's ``eval_shape(init_params)``, ``prefix_proj`` (2048, 2048)
    among it, and the analytic count is the reference's;
  * ``dense_attention`` under the ``"prefix"`` mask (bidirectional over
    ``k_pos < prefix_len``, causal after) to 1e-5 of its largest element;
  * the reduced paligemma from the JAX package's weights, with 16
    patches projected and prepended to the text: the logits cover the
    text only, and loss (1e-5 relative) and every gradient leaf (1e-4 of
    its largest element) match at 48 text tokens (dense prefix
    attention) and at 3056 (3072 in all: the ``"F"`` layers take
    ``flash_attention`` under the prefix mask, its blocks recomputed in
    the backward pass);
  * one SCAFFOLD ``federated_round`` against the reference's on the same
    (S, K) batch, ``patches`` included: x, c and c_i as in
    ``tests/test_torch_minitron.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from test_torch_minitron import (
    _close,
    _torch_batch,
    assert_config_is_a_copy,
    assert_federated_round_matches,
    assert_layout_matches_jax,
    assert_loss_and_grads_match,
    jax_weights,
    make_batch,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

ARCH = "paligemma-3b"


@pytest.fixture(scope="module")
def weights():
    return jax_weights(ARCH)


def test_config_is_a_copy():
    assert_config_is_a_copy(ARCH)
    assert get_config(ARCH).num_prefix_tokens == 256
    assert get_reduced(ARCH).num_prefix_tokens == 16


def test_full_config_layout_and_count_match_jax():
    got = assert_layout_matches_jax(ARCH)
    assert TM.count_params_analytic(get_config(ARCH)) == 2_512_857_088
    assert got["prefix_proj"].shape == (2048, 2048)
    assert "unembed" not in got  # tied


@pytest.mark.parametrize("sq", [40, 24], ids=["self", "q-suffix"])
def test_dense_prefix_mask_matches_jax(sq):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = JL.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask_kind="prefix", prefix_len=12)
    got = L.dense_attention(*map(torch.from_numpy, (q, k, v)),
                            mask_kind="prefix", prefix_len=12)
    _close(got, want, 1e-5)


def test_logits_cover_the_text_only(weights):
    cfg = get_reduced(ARCH)
    batch = _torch_batch(make_batch(cfg, np.random.default_rng(0), 20))
    logits, _ = TM.forward(cfg, params_from_jax(weights, device="cpu"),
                           batch)
    assert tuple(logits.shape) == (2, 20, cfg.vocab_size)
    want, _ = JM.forward(jax_get_reduced(ARCH), weights,
                         jax.tree.map(jnp.asarray, {
                             k: v.numpy() for k, v in batch.items()}))
    _close(logits, want, 1e-4)


@pytest.mark.parametrize("text_len", [48, 3056], ids=["dense", "flash"])
def test_loss_and_grads_match_jax(weights, text_len):
    assert_loss_and_grads_match(ARCH, weights, text_len)


def test_federated_round_matches_jax(weights):
    assert_federated_round_matches(ARCH, weights)
