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
  * a space mismatch and a base that differs by one bit raise.
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
