"""The port's package rules.

  * No file of ``src/repro_torch`` and neither ``chip_smoke.py`` imports
    JAX, ``ml_dtypes`` or anything of the JAX package ``repro`` (an AST
    walk), and importing the port leaves them out of ``sys.modules``.
  * Entry points default to the card and raise where there is none: no
    silent fallback to the CPU.
  * The copied configs mean the same as the JAX package's.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import FedRoundSpec as JSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec as TSpec
from repro_torch.configs.base import ModelConfig as TModelConfig

ROOT = Path(__file__).resolve().parents[1]
# ml_dtypes too: the card's machine has none (a bf16 checkpoint leaf is
# read from its raw 2-byte words instead)
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "local_loop_probe.py",
    ROOT / "tools" / "heavy_ball_kink_probe.py",
    ROOT / "tools" / "update_probe.py",
    ROOT / "tools" / "profile_cost_probe.py"]

no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the behaviour without CUDA")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_repro(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_import_leaves_jax_and_repro_unloaded():
    mods = sorted({".".join(p.relative_to(ROOT / "src").with_suffix("")
                            .parts).removesuffix(".__init__")
                   for p in PORT_FILES if "src" in p.parts})
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@no_cuda
def test_default_device_trainer_raises_without_cuda():
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import make_paper_fig3, quadratic_loss

    spec = TSpec(algorithm="scaffold", num_clients=2, num_sampled=2,
                 local_steps=1, local_batch=1)
    with pytest.raises(RuntimeError, match="cuda"):
        FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(20)},
                         spec, make_paper_fig3())


@no_cuda
def test_default_device_entry_points_raise_without_cuda():
    from repro_torch.convert import params_from_jax
    from repro_torch.data import (EmnistLikeFederated, SyntheticLMFederated,
                                  make_paper_fig3)
    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ops
    from repro_torch.models import model as M
    from repro_torch.models import simple

    emnist = EmnistLikeFederated(2, 40, 10.0, test_samples=8)

    x = torch.ones(8)
    calls = [
        lambda: ops.scaffold_update(x, x, x, 0.1),
        lambda: ops.scaffold_update_packed({"w": x}, {"w": x}, {"w": x},
                                           0.1),
        lambda: mk.scaffold_local_loop({"x": x}, None,
                                       {"A": torch.zeros(1, 1, 8, 8),
                                        "b": torch.zeros(1, 1, 8)},
                                       torch.ones(1)),
        lambda: M.init_params(get_reduced("llama3.2-3b")),
        lambda: params_from_jax({"w": x.numpy()}),
        lambda: make_paper_fig3().round_batches([0], 1, 1, None),
        lambda: SyntheticLMFederated(2, 16, 4).eval_batch(1, None),
        lambda: emnist.round_batches([0], 1, 2, np.random.default_rng(0)),
        lambda: emnist.test_batch(),
        lambda: simple.mlp_init(None, 784, 62),
        lambda: simple.mlp_init(torch.Generator().manual_seed(0), 784, 62),
        lambda: simple.logreg_init(None, 784, 62),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_wrapper_refuses_tensors_off_its_device():
    from repro_torch.kernels.scaffold_update import ops

    x = torch.ones(8)
    with pytest.raises((RuntimeError, ValueError)):
        ops.scaffold_update(x, x, x, 0.1, device="cuda")
    meta = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        ops.scaffold_update(meta, meta, meta, 0.1, device="cpu")


def test_fed_round_spec_is_a_field_for_field_copy():
    jf = [(f.name, f.default) for f in dataclasses.fields(JSpec)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TSpec)]
    assert jf == tf
    for kw in (dict(algorithm="scaffold_m"),
               dict(algorithm="scaffold", compress_uplink=True),
               dict(algorithm="fedavg", compress="topk_ef",
                    compress_k=4),
               dict(algorithm="scaffold", local_solver=""),
               dict(algorithm="sgd")):
        base = dict(num_clients=4, num_sampled=2, local_steps=2,
                    local_batch=1)
        j, t = JSpec(**base, **kw), TSpec(**base, **kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert bool(j.compress_uplink) == bool(t.compress_uplink)
        assert j.global_batch == t.global_batch
    for bad in (dict(algorithm="nope"), dict(algorithm="sgd", compress="int8_ef"),
                dict(algorithm="scaffold", privatizer="server_gauss")):
        with pytest.raises(AssertionError):
            JSpec(num_clients=4, num_sampled=2, local_steps=2, local_batch=1,
                  **bad)
        with pytest.raises(AssertionError):
            TSpec(num_clients=4, num_sampled=2, local_steps=2, local_batch=1,
                  **bad)


def test_model_config_and_llama_are_copies():
    assert ([f.name for f in dataclasses.fields(JModelConfig)]
            == [f.name for f in dataclasses.fields(TModelConfig)])
    for jc, tc in ((jax_get_config("llama3.2-3b"), get_config("llama3.2-3b")),
                   (jax_get_reduced("llama3.2-3b"),
                    get_reduced("llama3.2-3b"))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.pattern_for_layers() == tc.pattern_for_layers()


@pytest.mark.parametrize("name", ["InputShape", "TrainConfig"])
def test_input_shape_and_train_config_are_field_for_field_copies(name):
    import repro.configs.base as JB
    import repro_torch.configs.base as TB

    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(JB, name))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(TB, name))]
    assert jf == tf
    if name == "InputShape":
        j = JB.InputShape("s", seq_len=8, global_batch=2, kind="train")
        t = TB.InputShape("s", seq_len=8, global_batch=2, kind="train")
    else:
        base = dict(num_clients=4, num_sampled=2, local_steps=2,
                    local_batch=1, algorithm="scaffold")
        j = JB.TrainConfig(jax_get_reduced("llama3.2-3b"),
                           JSpec(**base), seq_len=64, rounds=3)
        t = TB.TrainConfig(get_reduced("llama3.2-3b"), TSpec(**base),
                           seq_len=64, rounds=3)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
