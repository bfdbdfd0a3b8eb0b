"""The port's training entry point, ``repro_torch.launch.train.main``, on
the CPU at the reduced preset.

  * ``--update-space lora`` trains, prints the trainable share, saves a
    checkpoint; a second ``main`` resumes from it, and its round equals
    round 3 of an unbroken run bitwise; the checkpoint serves through
    ``load_serving_params``;
  * ``head_only`` through the CLI trains only its targets;
  * ``--list-registries`` prints the port's registries, the reference's
    names among them (the store backends, availability models and
    staleness weightings too);
  * the async engine's flags, refused until the engine was ported, reach
    it: each builds the model or weighting it names;
  * ``--async-buffer`` trains through the async engine (lognormal
    stragglers with dropout, polynomial weighting), logs the reference's
    line, checkpoints with updates in flight, and a resumed ``main``
    equals the unbroken run bitwise;
  * ``--scan-rounds`` trains through the scanned engine and logs it.
"""
import pytest
import torch

from repro.core import (
    algorithm_names as jax_algorithm_names,
    availability_names as jax_availability_names,
    staleness_weighting_names as jax_staleness_weighting_names,
    store_backend_names as jax_store_backend_names,
    update_space_names as jax_update_space_names,
)
from repro_torch.checkpoint import load_serving_params
from repro_torch.launch.train import main

BASE = ["--preset", "reduced", "--device", "cpu", "--clients", "4",
        "--sampled", "2", "--local-steps", "2", "--local-batch", "1",
        "--seq-len", "32", "--log-every", "1"]
LORA = ["--update-space", "lora", "--lora-rank", "4"]


def test_lora_trains_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "lora")
    first = main(BASE + LORA + ["--rounds", "2", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert "update space: lora" in out and "x fewer" in out
    assert sum(line.startswith("round ") for line in out.splitlines()) == 2
    assert f"checkpoint saved to {ck}" in out
    assert [m["update_space"] for m in first.history] == ["lora", "lora"]
    resumed = main(BASE + LORA + ["--rounds", "1", "--resume", ck + ".npz"])
    assert "resumed from" in capsys.readouterr().out
    unbroken = main(BASE + LORA + ["--rounds", "3"])
    assert resumed.round_idx == unbroken.round_idx == 3
    for k, v in unbroken.x.items():
        assert torch.equal(resumed.x[k], v), k
    assert resumed.history[-1] == unbroken.history[-1]
    served = load_serving_params(ck + ".npz", device="cpu")
    for k, v in first.eval_params().items():
        assert torch.equal(served[k], v), k


def test_head_only_trains_its_targets():
    tr = main(BASE + ["--update-space", "head_only", "--lora-targets",
                      "embed,ln_final*", "--rounds", "1"])
    assert sorted(tr.x) == ["embed", "ln_final.scale"]
    assert not torch.equal(tr.x["embed"], tr.base_params["embed"])


def test_list_registries(capsys):
    assert main(["--list-registries"]) is None
    lines = dict(line.split(": ", 1)
                 for line in capsys.readouterr().out.splitlines())
    assert lines["algorithms"].split() == list(jax_algorithm_names())
    assert lines["update_spaces"].split() == list(jax_update_space_names())
    assert lines["store_backends"].split() == list(jax_store_backend_names())
    assert lines["availability_models"].split() == list(
        jax_availability_names())
    assert lines["staleness_weightings"].split() == list(
        jax_staleness_weighting_names())


@pytest.mark.parametrize("flag,want", [
    (["--max-inflight", "3"], ("max_inflight", 3)),
    (["--availability", "uniform", "--dropout", "0.25"],
     ("model", ("uniform", 0.25))),
    (["--staleness-weighting", "cutoff", "--staleness-cutoff", "2"],
     ("weighting", ("cutoff", 2.0)))])
def test_unported_engine_flags_raise(flag, want):
    """The async flags once raised ``NotImplementedError``; now each one
    reaches the engine, never ignored."""
    tr = main(BASE + ["--rounds", "1", "--async-buffer", "2"] + flag)
    eng = tr.async_engine
    assert tr.async_active and eng.buffer_size == 2
    attr, value = want
    got = getattr(eng, attr)
    if attr == "model":
        got = (got.name, got.dropout)
    elif attr == "weighting":
        got = (got.name, got.cutoff)
    assert got == value


ASYNC = ["--async-buffer", "2", "--max-inflight", "3", "--availability",
         "lognormal", "--latency-sigma", "1.0", "--dropout", "0.2",
         "--availability-seed", "3", "--staleness-weighting", "polynomial"]


def test_async_buffer_trains_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "async")
    first = main(BASE + ASYNC + ["--rounds", "2", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert ("async engine: aggregate 2 of 3 in flight, availability="
            "lognormal, staleness=polynomial") in out
    assert first.async_engine._inflight  # pending updates saved
    assert sum(sum(m["staleness_hist"]) for m in first.history) == 4
    resumed = main(BASE + ASYNC + ["--rounds", "2", "--resume", ck + ".npz"])
    unbroken = main(BASE + ASYNC + ["--rounds", "4"])
    assert resumed.round_idx == unbroken.round_idx == 4
    assert resumed.history == unbroken.history[2:]
    for k, v in unbroken.x.items():
        assert torch.equal(resumed.x[k], v), k


def test_scan_rounds_trains_scanned(capsys):
    """``--scan-rounds`` runs the scanned engine, logs the reference's
    line, and equals the per-round driving of the same engine."""
    tr = main(BASE + ["--rounds", "3", "--scan-rounds", "2"])
    assert tr.scan_active and tr.round_idx == 3
    assert "scanned engine: on-device chunks of <= 2 rounds" in (
        capsys.readouterr().out)
    one = main(BASE + ["--rounds", "3", "--scan-rounds", "1"])
    for k, v in tr.x.items():
        assert torch.equal(one.x[k], v), k
