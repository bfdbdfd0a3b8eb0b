"""The port's untied embeddings (minitron-4b) against the JAX package's,
on the CPU, and the parity helpers the paligemma and whisper files share.

  * the config (full and reduced) is a field-for-field copy;
  * the leaf paths, shapes and dtypes of the published config equal the
    reference's ``jax.eval_shape(init_params)``, built on the meta device
    (``model.param_tree``): ``unembed`` (3072, 256000) beside ``embed``;
  * the reduced minitron from the JAX package's weights: loss to 1e-5
    relative and every gradient leaf to 1e-4 of its largest element,
    with the full logits and with the streaming CE over vocab chunks
    (which reads ``unembed.T``);
  * one SCAFFOLD ``federated_round`` against the reference's on the same
    (S, K) batch: x to 1e-4 of each leaf's largest element, c and c_i to
    1e-4 of the larger of theirs and x's over ``K eta_l``;
  * ``head_only`` on ``unembed*,ln_final*`` (the reference's own
    example): two trainer rounds against the JAX trainer's host loop;
  * every gradient leaf is contiguous (the fused steps' contract), with
    the streaming CE too, which reads ``unembed`` in column blocks;
  * ``repro_torch.launch.train.main --arch minitron-4b`` at the reduced
    preset on the CPU, head_only on the same leaves, CE over vocab
    chunks.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.core import FederatedTrainer as JTrainer
from repro.data import SyntheticLMFederated as JLM
from repro.models import model as JM
from repro_torch import core as tcore
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree, params_from_jax, state_from_jax
from repro_torch.core import FederatedTrainer
from repro_torch.core.controller import make_grad_fn
from repro_torch.data import SyntheticLMFederated
from repro_torch.launch import train
from repro_torch.models import model as TM

ARCH = "minitron-4b"
HEAD = "unembed*,ln_final*"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models are small: one intra-op thread keeps them from
    oversubscribing the cores when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_weights(arch):
    """The reference's reduced parameters of ``arch`` as numpy leaves."""
    cfg = jax_get_reduced(arch)
    return jax.tree.map(np.asarray, jax.jit(partial(JM.init_params, cfg))(
        jax.random.key(0)))


@pytest.fixture(scope="module")
def weights():
    return jax_weights(ARCH)


def _close(got, want, tol, what="", atol=0.0):
    """Within the larger of ``tol`` of want's largest element and
    ``atol``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = max(tol * float(np.abs(want).max()), atol)
    assert float(np.abs(got - want).max()) <= bound, what


def make_batch(cfg, rng, text_len, lead=(2,)):
    """Numpy batch of ``cfg``: tokens and next-token labels (the last 5
    of the first row masked) of (*lead, text_len), plus the stub
    frontends' ``patches`` (prefix LM) or ``frames`` (encoder-decoder),
    normal draws of width d_model."""
    toks = rng.integers(0, cfg.vocab_size,
                        size=lead + (text_len + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels.reshape(-1, text_len)[0, -5:] = -1
    batch = {"tokens": np.maximum(toks[..., :-1], 0), "labels": labels}
    if cfg.num_prefix_tokens:
        batch["patches"] = rng.standard_normal(
            lead + (cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            lead + (cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def assert_config_is_a_copy(arch):
    for jc, tc in ((jax_get_config(arch), get_config(arch)),
                   (jax_get_reduced(arch), get_reduced(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.pattern_for_layers() == tc.pattern_for_layers()


def assert_layout_matches_jax(arch):
    """The published config's leaf paths, shapes and dtypes on the meta
    device equal the reference's ``eval_shape(init_params)``, and the
    analytic count is theirs; returns the port's meta tree."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    want = flatten_tree(shapes)
    got = TM.param_tree(tcfg, None, torch.device("meta"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == v.dtype.name, k
    n = sum(int(np.prod(v.shape)) for v in want.values())
    assert TM.count_params_analytic(tcfg) == n
    return got


def assert_loss_and_grads_match(arch, weights, text_len, **changes):
    """Loss to 1e-5 relative, every gradient leaf to 1e-4 of its largest
    element, on one seeded batch of two rows; ``changes`` alter both
    packages' reduced config alike."""
    jcfg = dataclasses.replace(jax_get_reduced(arch), **changes)
    tcfg = dataclasses.replace(get_reduced(arch), **changes)
    batch = make_batch(tcfg, np.random.default_rng(1), text_len)
    (lj, mj), gj = jax.jit(jax.value_and_grad(partial(JM.loss_fn, jcfg),
                                              has_aux=True))(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    gt, mt = make_grad_fn(partial(TM.loss_fn, tcfg))(
        params_from_jax(weights, device="cpu"), _torch_batch(batch))
    assert abs(float(mt["loss"]) - float(lj)) <= 1e-5 * abs(float(lj))
    assert float(mt["ntokens"]) == float(mj["ntokens"])
    gj = flatten_tree(jax.tree.map(np.asarray, gj))
    assert sorted(gj) == sorted(gt)
    for k, g in gj.items():
        _close(gt[k], g, 1e-4, k)


def assert_federated_round_matches(arch, weights, text_len=32):
    """One SCAFFOLD round of the seed shim ``federated_round`` in both
    packages from the same x, c and c_i (small seeded normals) on the
    same (S 2, K 2, b 1) batch. Each of x, c and c_i is held to 1e-4 of
    each leaf's largest element. c and c_i, Option II's ``(x - y_K) / (K
    eta_l)`` less c, get an absolute floor of 16 fp32 eps of x's largest
    element over ``K eta_l``: a step's rounding of y is an ulp of x, and
    the difference divides it by ``K eta_l``."""
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05)
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(2)
    batch = make_batch(tcfg, rng, text_len, lead=(2, 2, 1))
    x = flatten_tree(weights)
    c = {k: (0.01 * rng.standard_normal(v.shape)).astype(v.dtype)
         for k, v in x.items()}
    c_i = {k: (0.01 * rng.standard_normal((2,) + v.shape)).astype(v.dtype)
           for k, v in x.items()}

    def nest(flat):  # the reference's pytree of the flat paths
        return jax.tree.unflatten(jax.tree.structure(weights),
                                  [jnp.asarray(flat[k]) for k in x])

    jgrad = jcore.make_grad_fn(lambda p, b: JM.loss_fn(jcfg, p, b))
    jx, jc, jci, jm = jax.jit(lambda *a: jcore.federated_round(
        jgrad, JSpec(**kw), *a))(nest(x), nest(c), nest(c_i),
                                 jax.tree.map(jnp.asarray, batch))
    tx, tc, tci, tm = tcore.federated_round(
        tcore.make_grad_fn(partial(TM.loss_fn, tcfg)), TSpec(**kw),
        params_from_jax(x, device="cpu"), params_from_jax(c, device="cpu"),
        params_from_jax(c_i, device="cpu"), _torch_batch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(
        float(jm["loss"]))
    want = {name: flatten_tree(jax.tree.map(np.asarray, t))
            for name, t in (("x", jx), ("c", jc), ("c_i", jci))}
    for name, got in (("x", tx), ("c", tc), ("c_i", tci)):
        assert sorted(got) == sorted(want[name]) == sorted(x), name
    k_eta = kw["local_steps"] * kw["eta_l"]
    for k, v in want["x"].items():
        _close(tx[k], v, 1e-4, f"x {k}")
        atol = 16 * np.finfo(np.float32).eps * float(np.abs(v).max()) / k_eta
        _close(tc[k], want["c"][k], 1e-4, f"c {k}", atol=atol)
        _close(tci[k], want["c_i"][k], 1e-4, f"c_i {k}", atol=atol)


def test_config_is_a_copy():
    assert_config_is_a_copy(ARCH)
    assert not get_config(ARCH).tie_embeddings


def test_full_config_layout_and_count_match_jax():
    got = assert_layout_matches_jax(ARCH)
    assert TM.count_params_analytic(get_config(ARCH)) == 5_096_279_040
    assert got["unembed"].shape == (3072, 256000)
    assert got["embed"].shape == (256000, 3072)
    assert len(got) == 12  # embed, unembed, ln_final and 9 layer leaves


@pytest.mark.parametrize("chunk", [0, 200], ids=["logits", "chunked-ce"])
def test_loss_and_grads_match_jax(weights, chunk):
    assert_loss_and_grads_match(ARCH, weights, 48, loss_chunk_vocab=chunk)


@pytest.mark.parametrize("chunk", [0, 200], ids=["logits", "chunked-ce"])
def test_unembed_gradient_is_contiguous(weights, chunk):
    """The fused steps take contiguous leaves: the streaming CE's
    gradient of ``unembed`` is the concatenation of its column blocks."""
    cfg = dataclasses.replace(get_reduced(ARCH), loss_chunk_vocab=chunk)
    batch = _torch_batch(make_batch(cfg, np.random.default_rng(3), 16))
    grads, _ = make_grad_fn(partial(TM.loss_fn, cfg))(
        params_from_jax(weights, device="cpu"), batch)
    assert all(g.is_contiguous() for g in grads.values())


def test_federated_round_matches_jax(weights):
    assert_federated_round_matches(ARCH, weights)


def test_head_only_unembed_rounds_match_jax(weights):
    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=1, eta_l=0.05,
              update_space="head_only", update_targets=HEAD)
    jcfg, tcfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jt = JTrainer(partial(JM.loss_fn, jcfg),
                  lambda key: jax.tree.map(jnp.asarray, weights), JSpec(**kw),
                  JLM(4, jcfg.vocab_size, 32), seed=0, use_fused_update=True)
    tt = FederatedTrainer(partial(TM.loss_fn, tcfg),
                          lambda gen: params_from_jax(weights, device="cpu"),
                          TSpec(**kw), SyntheticLMFederated(
                              4, tcfg.vocab_size, 32), seed=0,
                          use_fused_update=True, device="cpu")
    assert sorted(tt.x) == ["ln_final.scale", "unembed"]  # escaped paths
    for _ in range(2):
        mj, mt = jt.run_round(), tt.run_round()
        assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
        assert int(mt["bytes_up"]) == int(mj["bytes_up"])
    want = state_from_jax(jax.tree.map(np.asarray, jt.server), device="cpu")
    assert sorted(want.x) == sorted(tt.x)
    for k, v in want.x.items():
        _close(tt.x[k], v.numpy(), 1e-4, k)
    got, ref = tt.eval_params(), flatten_tree(
        jax.tree.map(np.asarray, jt.eval_params()))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        _close(got[k], v, 1e-4, k)


def test_train_entry_point_runs_minitron(capsys):
    tr = train.main(["--arch", ARCH, "--preset", "reduced", "--device", "cpu",
                     "--rounds", "2", "--log-every", "1", "--clients", "4",
                     "--sampled", "2", "--local-steps", "2", "--local-batch",
                     "1", "--seq-len", "32", "--loss-chunk-vocab", "200",
                     "--update-space", "head_only", "--lora-targets", HEAD])
    out = capsys.readouterr().out
    assert "arch=minitron-4b" in out and "update space: head_only" in out
    assert sorted(tr.x) == ["ln_final.scale", "unembed"]
    assert all(bool(torch.isfinite(v).all()) for v in tr.eval_params().values())
