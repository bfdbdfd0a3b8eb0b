"""The port's gemma3 family against the JAX package's, on the CPU.

  * the config is a field-for-field copy;
  * the gelu-gated MLP (tanh-approximate gelu, as ``jax.nn.gelu``) to
    1e-5 of its largest element, a bound an exact-erf gelu misses;
  * the bf16 embedding scale bit-equal at d_model 1152 (sqrt(1152) is
    rounded to bf16 first, 33.94 -> 34.0);
  * ``params_from_jax`` carries gemma3-1b's 9-group layer tree across;
  * the reduced gemma3 (fp32, "WF", window 64) from the JAX package's
    weights: loss to 1e-5 relative and every gradient leaf to 1e-4 of its
    largest element, at seq 128 (the W layer's band path, through the
    sliding-window op) and seq 64 (dense sliding attention);
  * two SCAFFOLD rounds of ``FederatedTrainer`` against the JAX trainer's
    host loop at seq 128: the same cohorts and the final x per leaf to
    1e-4 of its largest element.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import SyntheticLMFederated as JLM
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree, params_from_jax, state_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import SyntheticLMFederated
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import transformer as T

ARCH = "gemma3-1b"


@pytest.fixture(scope="module")
def weights():
    cfg = jax_get_reduced(ARCH)
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))


def _record_cohorts(trainer):
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def test_config_is_a_copy():
    for jc, tc in ((jax_get_config(ARCH), get_config(ARCH)),
                   (jax_get_reduced(ARCH), get_reduced(ARCH))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.pattern_for_layers() == tc.pattern_for_layers()


def test_full_width_param_count_matches_jax():
    n = TM.count_params_analytic(get_config(ARCH))
    assert n == JM.count_params_analytic(jax_get_config(ARCH)) == 999_812_736


def test_gelu_gated_mlp_matches_jax():
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (cfg.d_model, cfg.d_ff)),
                      ("w_up", (cfg.d_model, cfg.d_ff)),
                      ("w_down", (cfg.d_ff, cfg.d_model)))}
    want = np.asarray(JL.mlp_block(jax_get_reduced(ARCH),
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    got = L.mlp_block(cfg, tp, tx).numpy()
    bound = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    erf = ((F.gelu(tx @ tp["w_gate"]) * (tx @ tp["w_up"]))
           @ tp["w_down"]).numpy()
    assert np.abs(erf - want).max() > bound  # the bound sees exact-erf gelu


def test_embed_scale_is_rounded_to_bf16_as_the_reference():
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), d_model=1152,
                               vocab_size=64, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(get_reduced(ARCH), d_model=1152,
                               vocab_size=64, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    table = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 1152)).astype(np.float32)).to(torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, 64, (2, 8)).astype(np.int32)
    want = JM._embed(jcfg, {"embed": jnp.asarray(table.float().numpy(),
                                                 jnp.bfloat16)},
                     jnp.asarray(toks))
    got = TM._embed(tcfg, {"embed": table}, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    unrounded = (table[torch.from_numpy(toks).long()] * 1152 ** 0.5)
    assert not torch.equal(unrounded, got)  # the rounding is visible


def test_params_from_jax_carries_the_9_group_tree():
    tiny = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                d_ff=64, vocab_size=64)
    jcfg = dataclasses.replace(jax_get_config(ARCH), **tiny)
    tcfg = dataclasses.replace(get_config(ARCH), **tiny)
    groups = T.layer_groups(tcfg)
    assert [(g.kind, g.count) for g in groups] == [
        ("W", 5), ("F", 1)] * 4 + [("W", 2)]
    assert [(g.kind, g.count) for g in JT.layer_groups(jcfg)] == [
        (g.kind, g.count) for g in groups]
    theirs = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.key(0)))
    carried = params_from_jax(theirs, device="cpu")
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert sorted(carried) == sorted(ours)
    assert len({k.split("/")[1] for k in ours if k.startswith("layers/")}) == 9
    for k, v in flatten_tree(theirs).items():
        assert tuple(ours[k].shape) == v.shape, k
        assert ours[k].dtype == carried[k].dtype == torch.bfloat16, k
        assert np.array_equal(carried[k].float().numpy(),
                              np.asarray(v, np.float32)), k


@pytest.mark.parametrize("seq,band", [(128, True), (64, False)],
                         ids=["seq128-band", "seq64-dense"])
def test_loss_and_grads_match_jax(weights, monkeypatch, seq, band):
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    toks = np.random.default_rng(seq).integers(
        0, tcfg.vocab_size, size=(2, seq + 1)).astype(np.int32)
    toks[1, -5:] = -1  # masked labels
    calls = []
    op = L.swa_attention
    monkeypatch.setattr(L, "swa_attention",
                        lambda *a: calls.append(1) or op(*a))
    jb = {"tokens": jnp.asarray(np.maximum(toks[:, :-1], 0)),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(np.maximum(toks[:, :-1], 0)),
          "labels": torch.from_numpy(toks[:, 1:])}
    (lj, mj), gj = jax.value_and_grad(partial(JM.loss_fn, jcfg),
                                      has_aux=True)(
        jax.tree.map(jnp.asarray, weights), jb)
    gt, mt = make_grad_fn(partial(TM.loss_fn, tcfg))(
        params_from_jax(weights, device="cpu"), tb)
    assert len(calls) == (1 if band else 0)  # one W layer in "WF"
    assert abs(float(mt["loss"]) - float(lj)) <= 1e-5 * abs(float(lj))
    assert float(mt["ntokens"]) == float(mj["ntokens"])
    gj = flatten_tree(jax.tree.map(np.asarray, gj))
    assert sorted(gj) == sorted(gt)
    for k, g in gj.items():
        assert (np.abs(gt[k].numpy() - g).max()
                <= 1e-4 * max(np.abs(g).max(), 1e-30)), k


@pytest.mark.parametrize("strategy", ["client_sequential", "client_parallel"])
def test_trainer_two_scaffold_rounds_match_jax(weights, strategy):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05, strategy=strategy)
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    seq = 128
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, weights), JSpec(**kw),
                  JLM(4, jcfg.vocab_size, seq), seed=0, use_fused_update=True)
    tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                          lambda gen: params_from_jax(weights, device="cpu"),
                          TSpec(**kw), SyntheticLMFederated(
                              4, tcfg.vocab_size, seq), seed=0,
                          use_fused_update=True, device="cpu")
    cj, ct = _record_cohorts(jt), _record_cohorts(tt)
    for _ in range(2):
        mj, mt = jt.run_round(), tt.run_round()
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
    assert cj == ct
    want = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    assert sorted(want.x) == sorted(tt.x)
    for k, v in want.x.items():
        assert ((tt.x[k] - v).abs().max()
                <= 1e-4 * max(float(v.abs().max()), 1e-30)), k
