"""The port's encoder-decoder (whisper-tiny) against the JAX package's, on
the CPU.

  * ``EncoderConfig``'s fields and defaults equal the reference's, and
    the config (full and reduced) is a field-for-field copy;
  * the published config's leaf layout on the meta device equals the
    reference's ``eval_shape(init_params)`` (``encoder/layers/...``
    stacked over 4 layers, ``encoder/ln_post``, each decoder layer's
    ``ln_cross`` and ``cross``, layer norms' ``bias``), and the analytic
    count is the reference's;
  * layer norm (fp32 inside, eps 1e-5) and the plain gelu MLP (tanh
    gelu) to 1e-5 of their largest element, with scale and bias off
    their init;
  * ``apply_encoder`` over 64 frames to 1e-5 of its largest element;
  * the reduced whisper from the JAX package's weights: loss to 1e-5
    relative and every gradient leaf, the encoder's among them, to 1e-4
    of its largest element;
  * one SCAFFOLD ``federated_round`` against the reference's on the same
    (S, K) batch, ``frames`` included: x, c and c_i as in
    ``tests/test_torch_minitron.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import EncoderConfig as JEncoderConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import EncoderConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import transformer as T
from test_torch_minitron import (
    _close,
    assert_config_is_a_copy,
    assert_federated_round_matches,
    assert_layout_matches_jax,
    assert_loss_and_grads_match,
    jax_weights,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def weights():
    return jax_weights(ARCH)


def test_encoder_config_is_a_copy():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(EncoderConfig) == fields(JEncoderConfig)
    assert (dataclasses.asdict(EncoderConfig(2, 64))
            == dataclasses.asdict(JEncoderConfig(2, 64)))
    assert_config_is_a_copy(ARCH)
    assert type(get_config(ARCH).encoder) is EncoderConfig


def test_full_config_layout_and_count_match_jax():
    got = assert_layout_matches_jax(ARCH)
    assert TM.count_params_analytic(get_config(ARCH)) == 36_448_128
    assert got["encoder/layers/attn/wq"].shape == (4, 384, 384)
    assert got["encoder/ln_post/bias"].shape == (384,)
    assert got["layers/0/cross/wq"].shape == (4, 384, 384)
    assert got["layers/0/ln_cross/bias"].shape == (4, 384)
    assert {str(v.dtype) for v in got.values()} == {"torch.float32"}


def test_layer_norm_and_gelu_mlp_match_jax():
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    rng = np.random.default_rng(4)
    e = tcfg.d_model
    x = (3.0 + rng.standard_normal((2, 16, e))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(e)).astype(np.float32)
    b = (0.1 * rng.standard_normal(e)).astype(np.float32)
    _close(L.layer_norm(*map(torch.from_numpy, (x, w, b))),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-5, "layer norm")
    init = L.init_norm(tcfg, e, torch.float32, torch.device("cpu"))
    assert sorted(init) == ["bias", "scale"]
    assert bool((init["scale"] == 1).all()) and bool((init["bias"] == 0).all())
    p = jax.tree.map(np.asarray, JL.init_mlp(jcfg, jax.random.key(1),
                                             jnp.float32))
    assert sorted(p) == ["w_down", "w_up"]
    _close(L.mlp_block(tcfg, params_from_jax(p, device="cpu"),
                       torch.from_numpy(x)),
           JL.mlp_block(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
           1e-5, "gelu mlp")


def test_encoder_matches_jax(weights):
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    frames = np.random.default_rng(5).standard_normal(
        (2, tcfg.encoder.num_frames, tcfg.d_model)).astype(np.float32)
    want = JT.apply_encoder(jcfg, jax.tree.map(jnp.asarray,
                                               weights["encoder"]),
                            jnp.asarray(frames))
    got = T.apply_encoder(tcfg, T.sub(params_from_jax(weights, device="cpu"),
                                      "encoder"), torch.from_numpy(frames))
    _close(got, want, 1e-5)


def test_loss_and_grads_match_jax(weights):
    assert_loss_and_grads_match(ARCH, weights, 48)


def test_federated_round_matches_jax(weights):
    assert_federated_round_matches(ARCH, weights)
