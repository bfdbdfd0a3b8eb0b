"""The dry-run census (``repro_torch.launch.census``) and the dry-run
entry point (``repro_torch.launch.dryrun``) on the CPU.

  * FLOPs exact on the reference's trip-count programs
    (``tests/test_dist.py``), written as Python loops: 9 x 2 x 128^3 and
    15 x 2 x 64^3;
  * ``peak_bytes`` exact on programs whose live set is known (a freed
    temporary, views that allocate nothing, host arguments that count in
    no device byte);
  * a reduced llama3.2-3b round's census FLOPs within 2 % of the
    reference's ``analyze_hlo(...)["flops"]`` on the same round and
    shapes, remat off in both. Both count 2 |out| |contraction| of every
    matrix product, and the round's products are the same on both
    sides, so here they are equal; a difference would come from a
    product one side makes and the other does not (XLA's simplifier
    folding one, or a remat recomputing the forward);
  * the round's trip-count census (three small rounds) equals the
    census of the whole round;
  * a census of the card path (``device="cuda"``; without a card its
    fake tensors lie on the meta device that stands for the card's)
    counts B1 and B5 for a reduced gemma3 round at seq 128 (the band
    path) as the card launches them, S K dtype groups and S K "W"
    layers, and touches no process launch count; a census of the CPU
    path counts none;
  * outside a census, ``resolve_device("cuda")`` still raises without a
    card, and "meta" is no device of the port;
  * ``python -m repro_torch.launch.dryrun`` with ``--device cpu`` writes
    the JSON with the reference's top-level keys for a reduced config,
    ``--mesh 16x16`` adds the per-device bytes and nulls the partitioned
    program's flops and collectives, and ``long_500k`` is skipped where
    the reference skips it.
"""
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import SHAPES, InputShape, get_reduced
from repro_torch.configs.base import FedRoundSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.scaffold_update import ops as update_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import census as C
from repro_torch.launch import dryrun as D

# the top-level keys of the reference's dry-run JSON (run_combo's result)
REFERENCE_KEYS = ("arch", "shape", "mesh", "chips", "strategy", "tag",
                  "params", "active_params", "lower_s", "compile_s",
                  "memory", "cost_xla", "cost_struct", "collectives",
                  "collective_bytes", "roofline")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- flops and peak -----------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_flops_exact_on_the_trip_count_programs(device):
    def f(x, w):
        c = x
        for _ in range(8):
            c = torch.tanh(c @ w)
        return c @ w

    def g(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    r = C.census(f, _meta(128, 128), _meta(128, 128), device=device)
    assert r.flops == 9 * 2 * 128 ** 3
    assert r.bytes > 0
    r = C.census(g, _meta(64, 64), _meta(64, 64), device=device)
    assert r.flops == 15 * 2 * 64 ** 3
    assert r.kernel_launches == {}


def test_peak_bytes_exact_on_a_known_live_set():
    mib4 = 4 << 20

    def h(a):
        b = a * 2          # a, b live
        c = b + 1          # a, b, c live: 3 x 4 MiB
        del b              # a, c
        v = c.view(-1, 2).t()[0]  # views allocate nothing
        return (c * v.sum()).sum()  # a, c, the 0-d sum, the product

    r = C.census(h, _meta(1 << 20))
    assert r.argument_bytes == mib4
    assert r.peak_bytes == 3 * mib4 + 4
    assert r.output_bytes == 4
    # host arguments count in no device byte; their copy to the device does
    r = C.census(lambda a, hst: a + hst.to(a.device), _meta(1 << 20),
                 C.OnHost(_meta(1 << 20)))
    assert r.argument_bytes == mib4
    assert r.peak_bytes == 3 * mib4
    # and a CPU census counts the host's bytes
    r = C.census(lambda a: a * 2, _meta(1 << 20), device="cpu")
    assert (r.device, r.stand, r.peak_bytes) == ("cpu", "cpu", 2 * mib4)


def _llama_round_flops(strategy):
    from repro.configs import get_reduced as jget
    from repro.configs.base import FedRoundSpec as JSpec
    from repro.core import federated_round as jround
    from repro.core import make_grad_fn as jgrad
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import model as JM

    kw = dict(algorithm="scaffold", num_clients=4, num_sampled=2,
              local_steps=2, local_batch=2, eta_l=0.01, strategy=strategy)
    seq = 64
    jcfg = dataclasses.replace(jget("llama3.2-3b"), remat=False)
    x = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    ci = jax.tree.map(lambda a: jax.ShapeDtypeStruct((2,) + a.shape,
                                                     a.dtype), x)
    b = {k: jax.ShapeDtypeStruct((2, 2, 2, seq), jnp.int32)
         for k in ("tokens", "labels")}
    step = partial(jround, jgrad(partial(JM.loss_fn, jcfg)), JSpec(**kw))
    want = analyze_hlo(jax.jit(step).lower(x, x, ci, b).compile().as_text())
    cfg = dataclasses.replace(get_reduced("llama3.2-3b"), remat=False)
    got = D.step_census(cfg, InputShape("t", seq, 8, "train"),
                        FedRoundSpec(**kw), device="cpu",
                        use_fused_update=False)
    return got.flops, want["flops"]


@pytest.mark.parametrize("strategy", ["client_parallel", "client_sequential"])
def test_llama_round_flops_within_2_percent_of_analyze_hlo(strategy):
    got, want = _llama_round_flops(strategy)
    assert want > 0
    assert abs(got - want) <= 0.02 * want, (got, want)


# -- the round census ---------------------------------------------------------


def _gemma_round(s=2, k=2, b=2, seq=128):
    cfg = D.make_config("gemma3-1b", preset="reduced")
    spec = FedRoundSpec(algorithm="scaffold", num_clients=max(s, 2),
                        num_sampled=s, local_steps=k, local_batch=b)
    return cfg, spec, InputShape("t", seq, s * k * b, "train")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_trip_count_census_equals_the_whole_round(device):
    cfg, spec, shape = _gemma_round(s=3, k=3)
    got = D.round_census(cfg, spec, shape, device)
    want = D._round_census(cfg, spec, shape, device, True)
    assert got.flops == want.flops and got.ops == want.ops
    assert got.bytes == want.bytes
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.kernel_launches == want.kernel_launches
    assert got.argument_bytes == want.argument_bytes
    # the whole round's peak lies its metrics' few 0-d tensors above
    assert 0 <= want.peak_bytes - got.peak_bytes <= 64


def test_card_path_census_counts_b1_and_b5_as_the_card_launches():
    cfg, spec, shape = _gemma_round()
    before = (dict(update_ops.LAUNCHES), dict(swa_ops.LAUNCHES))
    card = D.step_census(cfg, shape, spec, device="cuda")
    steps = spec.num_sampled * spec.local_steps
    n_w = cfg.pattern_for_layers().count("W")
    assert shape.seq_len % cfg.sliding_window == 0  # the band path
    assert card.kernel_launches == {"scaffold_update": steps * 1,
                                    "swa_attention": steps * n_w}
    assert card.device == "cuda"
    assert card.stand == ("cuda" if torch.cuda.is_available() else "meta")
    assert (dict(update_ops.LAUNCHES), dict(swa_ops.LAUNCHES)) == before
    plain = D.step_census(cfg, shape, spec, device="cpu")
    assert plain.kernel_launches == {}
    assert plain.stand == "cpu"


def test_resolve_device_outside_a_census():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


# -- the entry point ----------------------------------------------------------


def test_dryrun_cli_writes_the_reference_keys(tmp_path, capsys):
    out = D.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                  "--preset", "reduced", "--device", "cpu",
                  "--out-dir", str(tmp_path), "--tag", "t"])
    path = tmp_path / "llama3.2-3b__decode_32k__1x1__t.json"
    data = json.loads(path.read_text())
    assert set(REFERENCE_KEYS) <= set(data)
    assert data == json.loads(json.dumps(out))
    assert data["device"] == "cpu" and data["strategy"] == "serve"
    assert data["collectives"] == {} and data["compile_s"] is None
    mem = data["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert data["cost_struct"]["flops"] > 0
    assert data["roofline"]["dominant"] in ("compute", "memory")


def test_dryrun_cli_train_at_a_mesh(tmp_path):
    out = D.main(["--arch", "gemma3-1b", "--shape", "train_4k",
                  "--preset", "reduced", "--device", "cpu", "--mesh",
                  "16x16", "--out-dir", str(tmp_path)])
    assert out["round_spec"] == {"num_sampled": 16, "local_steps": 4,
                                 "local_batch": 4}
    assert out["chips"] == 256 and out["collectives"] is None
    per = out["memory"]["per_device"]
    assert per["flops"] is None and per["collectives"] is None
    assert "partitioner" in per["why"]
    assert per["total"] == per["x"] + per["c"] + per["c_i"] + per["batch"]
    # c_i's client axis splits 16 ways over "data", the params' widest
    # dims over "model"
    assert 0 < per["c_i"] < 16 * per["x"]
    assert out["cost_struct"]["kernel_launches"] == {}


def test_dryrun_cli_skips_long_500k_where_the_reference_does(tmp_path,
                                                              capsys):
    from repro.configs import supports_shape as j_supports

    assert not j_supports("llama3.2-3b", "long_500k")
    assert D.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                   "--device", "cpu", "--out-dir", str(tmp_path)]) is None
    assert "SKIP" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())
    assert SHAPES["long_500k"].kind == "decode"
