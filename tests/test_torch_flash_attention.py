"""The port's blocked online-softmax attention (``layers.flash_attention``)
against the JAX package's ``flash_attention_jnp``, on the CPU.

  * under the ``"causal"``, ``"prefix"`` (prefix_len 256) and ``"full"``
    masks at S 3072 (three kv blocks of 1024), GQA n_rep 2, D 32, fp32:
    to 1e-5 of the output's largest element;
  * at a ragged S (2304, not a multiple of the block), where both
    packages take dense attention, under the same masks;
  * the gradients of q, k and v (each block recomputed in the backward
    pass) against ``jax.vjp`` at S 2048, to 1e-4 of each one's largest
    element;
  * ``attention_block`` of the reduced llama at S 3072 (past the 2048
    threshold, so its ``"F"`` layer takes ``flash_attention``) against
    the reference's, fp32, to 1e-4;
  * a bf16 input comes back in bf16, within 1 bf16 ulp of the fp32
    result plus 1e-5.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from test_torch_minitron import _close, one_torch_thread  # noqa: F401

MASKS = ["causal", "prefix", "full"]
PREFIX = 256


def _qkv(s, hq=4, hkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, hq, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32))


@partial(jax.jit, static_argnames="mask_kind")
def _jax_flash(q, k, v, mask_kind):
    return JL.flash_attention_jnp(q, k, v, mask_kind=mask_kind,
                                  prefix_len=PREFIX)


@pytest.mark.parametrize("s", [3072, 2304], ids=["blocked", "ragged"])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_flash_attention_matches_jax(s, mask_kind):
    q, k, v = _qkv(s)
    want = _jax_flash(q, k, v, mask_kind)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            mask_kind=mask_kind, prefix_len=PREFIX)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, mask_kind)


@pytest.mark.parametrize("mask_kind", ["causal", "prefix"])
def test_flash_attention_grads_match_jax(mask_kind):
    q, k, v = _qkv(2048, seed=1)
    ct = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _jax_flash(*a, mask_kind), q, k, v)
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = L.flash_attention(*leaves, mask_kind=mask_kind, prefix_len=PREFIX)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, g, w in zip("qkv", got, want):
        _close(g, w, 1e-4, name)


def test_attention_block_takes_flash_past_2048():
    jcfg, tcfg = jax_get_reduced("llama3.2-3b"), get_reduced("llama3.2-3b")
    p = jax.tree.map(np.asarray, JL.init_attention(jcfg, jax.random.key(3),
                                                   jnp.float32))
    s = 3072
    x = np.random.default_rng(3).standard_normal(
        (1, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (1, s))
    want = jax.jit(partial(JL.attention_block, jcfg, kind="F"))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos))
    got = L.attention_block(tcfg, params_from_jax(p, device="cpu"),
                            torch.from_numpy(x),
                            torch.from_numpy(pos.copy()).long(), kind="F")
    _close(got, want, 1e-4)


def test_bf16_input_stays_bf16():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2048, seed=4))
    want = L.flash_attention(q, k, v)
    got = L.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got.dtype == torch.bfloat16
    again = L.flash_attention(q.bfloat16().float(), k.bfloat16().float(),
                              v.bfloat16().float())
    ulp = torch.finfo(torch.bfloat16).eps * again.abs()
    assert bool(((got.float() - again).abs() <= ulp + 1e-5).all())
    assert float((again - want).abs().max()) < 0.1
