"""The port's training entry point, ``repro_torch.launch.train.main``, on
the CPU at the reduced preset.

  * ``--update-space lora`` trains, prints the trainable share, saves a
    checkpoint; a second ``main`` resumes from it, and its round equals
    round 3 of an unbroken run bitwise; the checkpoint serves through
    ``load_serving_params``;
  * ``head_only`` through the CLI trains only its targets;
  * ``--list-registries`` prints the port's registries, the reference's
    names among them;
  * the flags of engines the port has not yet raise
    ``NotImplementedError``, never ignored (the scanned engine runs; its
    tiered store does not);
  * ``--scan-rounds`` trains through the scanned engine and logs it.
"""
import pytest
import torch

from repro.core import (
    algorithm_names as jax_algorithm_names,
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


@pytest.mark.parametrize("flag", [["--pipeline-depth", "1"],
                                  ["--scan-rounds", "2", "--store", "tiered"],
                                  ["--async-buffer", "2"],
                                  ["--store", "tiered"],
                                  ["--store-backend", "memmap"],
                                  ["--availability", "uniform"],
                                  ["--staleness-weighting", "polynomial"]])
def test_unported_engine_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        main(BASE + ["--rounds", "1"] + flag)


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
