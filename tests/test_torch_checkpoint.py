"""The port's checkpoints against the JAX package's, on the CPU.

  * a port checkpoint read by the reference's ``load_trainer``, and a
    reference checkpoint read by the port's: the next round agrees with
    the unbroken run of the other package to the parity tolerance (1e-5
    of a leaf's largest element; x, c, c_i and slot rows). These run in
    fp32: the reference's loader keeps a bf16 leaf as the raw 2-byte
    words ``np.savez`` wrote (dtype ``|V2``), which JAX cannot train on,
    so a bf16 checkpoint crosses only into the port;
  * ``load_serving_params`` of either package's checkpoint agrees with
    the reference's;
  * a bf16 checkpoint round-trips in the port bitwise, its bf16 leaves
    stored as ``|V2``;
  * resume is bitwise: 2 rounds, save, a fresh trainer loads and runs
    round 3, equal to 3 unbroken rounds in every array and metric;
  * a space mismatch and a base that differs by one bit raise;
  * the async engine's pending state: a checkpoint taken mid-buffer, with
    updates in flight and buffered, resumes bitwise in the port (int8_ef
    and server adam; local heavy-ball with server noise, so slot rows and
    clip flags ride along; a tiered memmap store); a mid-buffer
    checkpoint of the reference's async engine loads into the port, and
    the port's into the reference's, and both continue on the writer's
    event stream within 1e-5 of max|x| of its unbroken run; a sync
    checkpoint loaded into an async trainer raises.
"""
import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_serving_params as jax_load_serving
from repro.checkpoint import load_trainer as jax_load_trainer
from repro.checkpoint import save_trainer as jax_save_trainer
from repro_torch.checkpoint import (
    load_serving_params,
    load_trainer,
    save_trainer,
)
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.convert import flatten_tree
from repro_torch.core import FederatedTrainer
from repro_torch.data import SyntheticLMFederated
from repro_torch.models import model as TM

from test_torch_async_engine import ASYNC_KW, EVENTS
from test_torch_async_engine import _against_reference as async_against
from test_torch_async_engine import _jax_quad_trainer, _quad_trainer
from test_torch_async_engine import _state as async_state
from test_torch_async_engine import one_torch_thread  # noqa: F401 (fixture)
from test_torch_update_space import (  # noqa: F401  (fixtures)
    _close,
    assert_trainers_agree,
    emnist,
    trainer_pair,
    weights,
)

TOL = 1e-5


@pytest.mark.parametrize("solver", ["sgd", "momentum"])
def test_checkpoints_cross_packages_both_ways(weights, emnist, tmp_path,
                                              solver):
    jt, tt = trainer_pair(weights, "mlp", "lora", emnist,
                          local_solver=solver)
    for _ in range(2):
        jt.run_round(), tt.run_round()
    save_trainer(str(tmp_path / "port"), tt)
    jax_save_trainer(str(tmp_path / "ref"), jt)
    # each package resumes from the other's checkpoint
    jt2, tt2 = trainer_pair(weights, "mlp", "lora", emnist,
                            local_solver=solver)
    jax_load_trainer(str(tmp_path / "port.npz"), jt2)
    load_trainer(str(tmp_path / "ref.npz"), tt2)
    assert jt2.round_idx == tt2.round_idx == 2
    for pair in ((jt, tt2), (jt2, tt)):
        assert_trainers_agree(*pair, TOL)
    mj, mt = jt.run_round(), tt2.run_round()
    assert mt["bytes_up"] == mj["bytes_up"] and mt["round"] == mj["round"]
    assert_trainers_agree(jt, tt2, TOL)
    mj, mt = jt2.run_round(), tt.run_round()
    assert abs(mt["loss"] - mj["loss"]) <= 1e-4 * abs(mj["loss"])
    assert_trainers_agree(jt2, tt, TOL)


def test_serving_params_agree_with_the_reference(weights, emnist, tmp_path):
    jt, tt = trainer_pair(weights, "mlp", "lora", emnist)
    for _ in range(2):
        jt.run_round(), tt.run_round()
    save_trainer(str(tmp_path / "port"), tt)
    jax_save_trainer(str(tmp_path / "ref"), jt)
    for name in ("port", "ref"):
        path = str(tmp_path / f"{name}.npz")
        got = load_serving_params(path, device="cpu")
        want = flatten_tree(jax.tree.map(np.asarray, jax_load_serving(path)))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _close(got[k], v, TOL, k)
    mine = load_serving_params(str(tmp_path / "port.npz"), device="cpu")
    for k, v in tt.eval_params().items():
        assert torch.equal(mine[k], v), k


def _bf16_trainer(space="head_only", seed=0, **kw):
    cfg = dataclasses.replace(get_reduced("llama3.2-3b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    sp = dict(update_space=space)
    if space == "head_only":
        sp["update_targets"] = "embed,ln_final*"
    elif space == "lora":
        sp["lora_rank"] = 4
    spec = TSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                 local_steps=2, local_batch=1, eta_l=0.05,
                 local_solver="momentum", **sp, **kw)
    return FederatedTrainer(
        partial(TM.loss_fn, cfg),
        lambda gen: TM.init_params(cfg, gen, device="cpu"), spec,
        SyntheticLMFederated(4, cfg.vocab_size, 32), seed=seed,
        use_fused_update=True, device="cpu")


def _state(tr):
    rows = {f"store/{k}": v for k, v in tr.store.all_rows().items()}
    if tr.solver_store is not None:
        rows.update({f"slots/{k}": v for k, v in tr.solver_store.all_rows().items()})
    return {**{f"x/{k}": v for k, v in tr.x.items()},
            **{f"c/{k}": v for k, v in tr.c.items()}, **rows}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("space", ["head_only", "full"])
def test_bf16_resume_is_bitwise(tmp_path, space):
    """2 rounds, save, a fresh trainer loads and runs round 3 == 3
    unbroken rounds, in a bf16 model (its delta leaves and store rows
    bf16, the heavy-ball slots fp32)."""
    unbroken = _bf16_trainer(space)
    for _ in range(3):
        unbroken.run_round()
    first = _bf16_trainer(space)
    for _ in range(2):
        first.run_round()
    path = str(tmp_path / "ck")
    save_trainer(path, first)
    with np.load(path + ".npz") as data:
        assert data["x/embed"].dtype == np.dtype("V2")
        assert data["solver_slots/m/embed"].dtype == np.float32
        if space != "full":
            assert data["base/embed"].dtype == np.dtype("V2")
    resumed = _bf16_trainer(space)
    load_trainer(path, resumed)
    assert resumed.round_idx == 2
    resumed.run_round()
    assert unbroken.x["embed"].dtype == torch.bfloat16
    _assert_bitwise(_state(resumed), _state(unbroken))
    assert resumed.history[-1] == unbroken.history[-1]
    _assert_bitwise(load_serving_params(path + ".npz", device="cpu"),
                    first.eval_params())


def test_space_mismatch_and_a_differing_base_raise(tmp_path):
    tr = _bf16_trainer("head_only")
    tr.run_round()
    path = str(tmp_path / "ck")
    save_trainer(path, tr)
    with pytest.raises(ValueError, match="update_space='head_only'"):
        load_trainer(path, _bf16_trainer("lora"))
    with pytest.raises(ValueError, match="update_space='head_only'"):
        load_trainer(path, _bf16_trainer("full"))
    other = _bf16_trainer("head_only")
    key = "layers/0/mlp/w_up"
    other.base_params[key].view(-1).view(torch.int16)[7] += 1  # one bit
    with pytest.raises(ValueError, match="base parameters differ"):
        load_trainer(path, other)
    # the same seed and config load
    load_trainer(path, _bf16_trainer("head_only"))


ASYNC_CASES = {
    "int8-adam": (dict(compress="int8_ef", server_optimizer="adam"), {}),
    "heavy-ball-server-noise": (
        dict(local_solver="momentum", local_momentum=0.9,
             privatizer="server_gauss", clip_norm=0.05,
             noise_multiplier=0.5), {}),
    "tiered-memmap": (dict(compress="int8_ef"),
                      dict(store="tiered", store_backend="memmap")),
}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
@pytest.mark.usefixtures("one_torch_thread")
def test_async_mid_buffer_resume_is_bitwise(case, tmp_path):
    """Save with updates in flight and in the buffer (M < K), restore into
    a trainer of another seed: the resumed run equals the unbroken one
    bitwise, its event stream and every metric included."""
    spec_kw, kw = ASYNC_CASES[case]
    full = _quad_trainer(spec_kw=spec_kw, **kw, **ASYNC_KW)
    hist_full = [full.run_round() for _ in range(8)]
    part = _quad_trainer(spec_kw=spec_kw, **kw, **ASYNC_KW)
    hist_part = [part.run_round() for _ in range(4)]
    eng = part.async_engine
    # an aggregation empties the buffer: step until updates are buffered
    while not eng._buffer:
        assert eng.step() is None
    assert eng._inflight  # genuinely mid-state
    path = str(tmp_path / "async_ckpt")
    save_trainer(path, part)
    with np.load(path + ".npz") as data:
        n = len(eng._inflight) + len(eng._buffer)
        assert data["async/dy/x"].shape == (n, 6)
        assert data["async/dispatch_k"].dtype == np.int64
    resumed = _quad_trainer(seed=99, spec_kw=spec_kw, **kw, **ASYNC_KW)
    load_trainer(path, resumed)
    assert len(resumed.async_engine._buffer) == len(eng._buffer)
    hist_res = hist_part + [resumed.run_round() for _ in range(4)]
    assert hist_full == hist_res
    want, got = async_state(full), async_state(resumed)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for tr in (full, part, resumed):
        tr.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.usefixtures("one_torch_thread")
def test_async_checkpoints_cross_packages(writer, tmp_path):
    """An async checkpoint with updates pending resumes in the other
    package (the port's taken with updates in flight and buffered; the
    reference's engine has no step, so its has them in flight): the
    reader continues on the writer's event stream, within 1e-5 of
    max|x| of the writer's unbroken run."""
    kw = dict(spec_kw=dict(compress="int8_ef"), **ASYNC_KW)
    jt, tt = _jax_quad_trainer(**kw), _quad_trainer(**kw)
    path = str(tmp_path / "ck")
    if writer == "reference":
        for _ in range(4):
            jt.run_round()
        assert jt.async_engine._inflight
        jax_save_trainer(path, jt)
        reader = _quad_trainer(seed=99, **kw)
        load_trainer(path + ".npz", reader)
        pair = (jt, reader)
    else:
        for _ in range(4):
            tt.run_round()
        while not tt.async_engine._buffer:
            tt.async_engine.step()
        save_trainer(path, tt)
        reader = _jax_quad_trainer(seed=99, **kw)
        jax_load_trainer(path + ".npz", reader)
        pair = (reader, tt)
    assert reader.round_idx == 4
    for _ in range(4):
        mj, mt = pair[0].run_round(), pair[1].run_round()
        for key in EVENTS:
            assert mj[key] == mt[key], key
    async_against(*pair)


@pytest.mark.usefixtures("one_torch_thread")
def test_sync_checkpoint_into_async_trainer_fails_loudly(tmp_path):
    sync = _quad_trainer()
    sync.run_round()
    path = str(tmp_path / "sync_ckpt")
    save_trainer(path, sync)
    with pytest.raises(ValueError, match="no async-engine state"):
        load_trainer(path, _quad_trainer(async_buffer=5, max_inflight=5))
