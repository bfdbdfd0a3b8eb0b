"""The port's Mamba2 SSD block and mamba2 family against the JAX
package's, on the CPU.

  * ``SSMConfig`` and the mamba2-2.7b config (full and reduced) are
    field-for-field copies;
  * ``_ssd_chunked`` in fp32: y and the final state to 1e-5 of their
    largest element, at a sequence that is a multiple of the chunk, one
    that is not (the chunk halved until it divides) and one shorter than
    the chunk;
  * ``mamba_block``: the forward and every parameter's gradient (a vjp
    of a seeded cotangent) to 1e-4 of the leaf's largest element;
  * the reduced mamba2 from the JAX package's weights: loss to 1e-5
    relative and every gradient leaf to 1e-4 of its largest element;
  * ``count_params_analytic`` at the full config equals the reference's,
    and the leaf paths, shapes and dtypes equal the reference's
    ``jax.eval_shape(init_params)``, built on the meta device (nothing
    allocated); a bf16 model keeps ``a_log``, ``dt_bias`` and ``d_skip``
    in fp32, and ``params_from_jax`` carries such a tree with its dtypes;
  * two SCAFFOLD rounds of ``FederatedTrainer`` against the JAX trainer's
    host loop: the same cohorts, final x per leaf to 1e-4 of its largest
    element;
  * LoRA on mamba2 finds no default target and is refused as the
    reference refuses it.
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
from repro.configs.base import SSMConfig as JSSMConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import update_space as JU
from repro.data import SyntheticLMFederated as JLM
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import flatten_tree, params_from_jax, state_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.core import update_space as TU
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import SyntheticLMFederated
from repro_torch.models import layers as L
from repro_torch.models import model as TM

ARCH = "mamba2-2.7b"


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
    cfg = jax_get_reduced(ARCH)
    return jax.tree.map(np.asarray, jax.jit(partial(JM.init_params, cfg))(
        jax.random.key(0)))


def _close(got, want, tol, what=""):
    """Within ``tol`` of want's largest element."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= bound, what


def _record_cohorts(trainer):
    drawn, sample = [], trainer.sampler.sample

    def recording():
        ids = sample()
        drawn.append(np.asarray(ids).tolist())
        return ids

    trainer.sampler.sample = recording
    return drawn


def test_config_is_a_copy():
    assert (dataclasses.asdict(SSMConfig(d_state=8))
            == dataclasses.asdict(JSSMConfig(d_state=8)))
    ssm = get_config(ARCH).ssm
    assert (ssm.d_inner(2560), ssm.n_heads(2560)) == (5120, 80)
    for jc, tc in ((jax_get_config(ARCH), get_config(ARCH)),
                   (jax_get_reduced(ARCH), get_reduced(ARCH))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert type(tc.ssm) is SSMConfig
        assert jc.pattern_for_layers() == tc.pattern_for_layers()


@pytest.mark.parametrize("s,chunk", [(64, 32), (48, 32), (20, 32)],
                         ids=["multiple", "halved", "shorter"])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 16, 8
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bmat, cmat = (rng.standard_normal((b, s, n)).astype(np.float32)
                  for _ in range(2))
    d_skip = rng.standard_normal(h).astype(np.float32)
    args = (xh, dt, a_log, bmat, cmat, d_skip)
    yj, sj = jax.jit(JL._ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk)
    yt, st = L._ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(yt, yj, 1e-5, "y")
    _close(st, sj, 1e-5, "final state")
    assert tuple(st.shape) == (b, h, n, p)


def test_mamba_block_forward_and_grads_match_jax():
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    rng = np.random.default_rng(3)
    p = jax.tree.map(np.asarray, JL.init_mamba(jcfg, jax.random.key(5),
                                               jnp.float32))
    # move the zero / one inits off their values, so each leaf's
    # gradient is exercised away from them
    for k in ("conv_b", "dt_bias", "d_skip"):
        p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(
            np.float32)
    p["out_norm"]["scale"] = (0.1 * rng.standard_normal(
        p["out_norm"]["scale"].shape)).astype(np.float32)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def fwd_vjp(p, x, ct):
        out, vjp = jax.vjp(partial(JL.mamba_block, jcfg), p, x)
        return out, vjp(ct)

    out_j, (gj_p, gj_x) = fwd_vjp(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jnp.asarray(ct))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_jax(p, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out_t = L.mamba_block(tcfg, tp, tx)
    _close(out_t, out_j, 1e-4, "out")
    grads = torch.autograd.grad(out_t, [tx, *tp.values()],
                                torch.from_numpy(ct))
    _close(grads[0], gj_x, 1e-4, "x")
    gj = flatten_tree(jax.tree.map(np.asarray, gj_p))
    assert sorted(gj) == sorted(tp)
    for k, g in zip(tp, grads[1:]):
        _close(g, gj[k], 1e-4, k)


def test_loss_and_grads_match_jax(weights):
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(2, 65)).astype(np.int32)
    toks[1, -5:] = -1  # masked labels
    jb = {"tokens": jnp.asarray(np.maximum(toks[:, :-1], 0)),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(np.maximum(toks[:, :-1], 0)),
          "labels": torch.from_numpy(toks[:, 1:])}
    (lj, mj), gj = jax.jit(jax.value_and_grad(partial(JM.loss_fn, jcfg),
                                              has_aux=True))(
        jax.tree.map(jnp.asarray, weights), jb)
    gt, mt = make_grad_fn(partial(TM.loss_fn, tcfg))(
        params_from_jax(weights, device="cpu"), tb)
    assert abs(float(mt["loss"]) - float(lj)) <= 1e-5 * abs(float(lj))
    assert float(mt["ntokens"]) == float(mj["ntokens"])
    gj = flatten_tree(jax.tree.map(np.asarray, gj))
    assert sorted(gj) == sorted(gt)
    for k, g in gj.items():
        _close(gt[k], g, 1e-4, k)


def meta_tree(cfg):
    """The port's parameter tree of ``cfg`` on the meta device: paths,
    shapes and dtypes, nothing allocated."""
    return TM.param_tree(cfg, None, torch.device("meta"))


def assert_layout_matches_jax(jcfg, tcfg):
    """The port's leaf paths, shapes and dtypes are the reference's
    ``eval_shape(init_params)``, and the counts agree."""
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    want = flatten_tree(shapes)
    got = meta_tree(tcfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == v.dtype.name, k
    n = sum(int(np.prod(v.shape)) for v in want.values())
    assert TM.count_params_analytic(tcfg) == n
    return got


def test_full_config_layout_and_count_match_jax():
    got = assert_layout_matches_jax(jax_get_config(ARCH), get_config(ARCH))
    assert TM.count_params_analytic(get_config(ARCH)) == 2_702_579_200
    assert len(got) == 2 + 9  # embed, ln_final; ln_attn and 8 mamba leaves
    for k in ("a_log", "dt_bias", "d_skip"):
        assert got[f"layers/0/mamba/{k}"].dtype == torch.float32
    assert got["layers/0/mamba/w_in"].shape == (64, 2560, 10576)
    assert got["layers/0/mamba/w_in"].dtype == torch.bfloat16


def test_params_from_jax_keeps_the_mixed_dtypes():
    """A bf16 mamba2's tree crosses with the nested ``out_norm/scale`` and
    the fp32 ``a_log``, ``dt_bias`` and ``d_skip`` kept fp32, bit for
    bit, under the port's own init's paths and dtypes."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), **kw)
    tcfg = dataclasses.replace(get_reduced(ARCH), **kw)
    theirs = flatten_tree(jax.tree.map(np.asarray, jax.jit(
        partial(JM.init_params, jcfg))(jax.random.key(1))))
    carried = params_from_jax(theirs, device="cpu")
    ours = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert sorted(carried) == sorted(ours) == sorted(theirs)
    fp32 = {k for k, v in ours.items() if v.dtype == torch.float32}
    assert fp32 == {f"layers/0/mamba/{k}"
                    for k in ("a_log", "dt_bias", "d_skip")}
    assert "layers/0/mamba/out_norm/scale" in carried
    for k, v in theirs.items():
        assert carried[k].dtype == ours[k].dtype, k
        assert np.array_equal(carried[k].float().numpy(),
                              np.asarray(v, np.float32)), k


def test_trainer_two_scaffold_rounds_match_jax(weights):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05,
              strategy="client_sequential")
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    seq = 64
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
        _close(tt.x[k], v.numpy(), 1e-4, k)


def test_lora_is_refused_as_the_reference_refuses_it(weights):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, update_space="lora",
              lora_rank=4)
    stem = "update_space='lora' matched no parameters"
    with pytest.raises(ValueError, match=stem):
        JU.get_update_space("lora").init_deltas(
            JSpec(**kw), jax.tree.map(jnp.asarray, weights),
            jax.random.key(4))
    with pytest.raises(ValueError, match=stem):
        TU.get_update_space("lora").init_deltas(
            TSpec(**kw), params_from_jax(weights, device="cpu"))
