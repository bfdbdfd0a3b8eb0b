"""The port's serving entry point (``repro_torch.launch.serve``) against the
JAX package's, on the CPU.

  * greedy ``generate`` on the reduced llama and gemma3 (past its
    window: the ring buffer wraps) from the reference's weights and the
    same prompts: the tokens equal the reference's ``generate``'s;
  * sampling (``temperature > 0``) draws from a ``torch.Generator``
    seeded by ``seed``: the same seed repeats, another differs;
  * ``main --device cpu --preset reduced``: the printed line, the
    tokens' shape and range;
  * ``--checkpoint`` from the port's ``launch.train.main --update-space
    lora`` on the CPU: "serving merged checkpoint", the served
    parameters bitwise ``load_serving_params``', the LoRA deltas merged;
  * a checkpoint of another architecture is refused (``SystemExit``),
    and so are the encoder-decoder and prefix-LM archs, with the
    reference's message;
  * ``main`` and ``generate`` on the default device raise without a card.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch import serve as jserve
from repro_torch.checkpoint import load_serving_params
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve, train
from repro_torch.models import model as TM
from test_torch_minitron import jax_weights

no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the behaviour without CUDA")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models are small: one intra-op thread keeps them from
    oversubscribing the cores when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,plen,new", [("llama3.2-3b", 8, 12),
                                           ("gemma3-1b", 48, 40)])
def test_greedy_tokens_match_jax(arch, plen, new):
    weights = jax_weights(arch)
    prompts = np.random.default_rng(6).integers(
        0, get_reduced(arch).vocab_size, (2, plen)).astype(np.int32)
    want = np.asarray(jserve.generate(
        jax_get_reduced(arch), jax.tree.map(jnp.asarray, weights),
        jnp.asarray(prompts), new))
    got = serve.generate(get_reduced(arch),
                         params_from_jax(weights, device="cpu"),
                         torch.from_numpy(prompts), new, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_follows_its_seed():
    cfg = get_reduced("llama3.2-3b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                            generator=torch.Generator().manual_seed(1))
    run = partial(serve.generate, cfg, params, prompts, 16, temperature=2.0,
                  device="cpu")
    a, b, c = run(seed=3), run(seed=3), run(seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, serve.generate(cfg, params, prompts, 16,
                                             device="cpu"))


def test_main_serves_on_the_cpu(capsys):
    served = serve.main(["--device", "cpu", "--preset", "reduced",
                         "--batch", "2", "--prompt-len", "6", "--max-new",
                         "5"])
    out = capsys.readouterr().out
    assert "generated (2, 5)" in out and "ms a decode step" in out
    assert served.tokens.shape == (2, 5) and served.steps == 11
    assert int(served.tokens.min()) >= 0
    assert int(served.tokens.max()) < get_reduced("llama3.2-3b").vocab_size
    assert served.peak_bytes == 0 and served.ms_per_step > 0


@pytest.fixture(scope="module")
def lora_checkpoint(tmp_path_factory):
    """A reduced-llama LoRA checkpoint of the port's train entry point."""
    path = tmp_path_factory.mktemp("ckpt") / "lora"
    train.main(["--preset", "reduced", "--device", "cpu", "--rounds", "2",
                "--log-every", "1", "--clients", "4", "--sampled", "2",
                "--local-steps", "2", "--local-batch", "1", "--seq-len",
                "16", "--update-space", "lora", "--lora-rank", "4",
                "--checkpoint", str(path)])
    return str(path) + ".npz"


def test_main_serves_a_merged_lora_checkpoint(lora_checkpoint, capsys):
    served = serve.main(["--device", "cpu", "--preset", "reduced",
                         "--checkpoint", lora_checkpoint, "--batch", "2",
                         "--prompt-len", "4", "--max-new", "4"])
    assert f"serving merged checkpoint {lora_checkpoint}" in \
        capsys.readouterr().out
    want = load_serving_params(lora_checkpoint, device="cpu")
    assert sorted(served.params) == sorted(want)
    assert all(torch.equal(served.params[k], v) for k, v in want.items())
    # the deltas are merged: the targets moved off the fresh init
    base = TM.init_params(get_reduced("llama3.2-3b"),
                          torch.Generator().manual_seed(0), device="cpu")
    assert not torch.equal(served.params["layers/0/attn/wq"],
                           base["layers/0/attn/wq"])
    assert served.tokens.shape == (2, 4)


def test_mismatched_checkpoint_is_refused(lora_checkpoint):
    with pytest.raises(SystemExit, match="does not match --arch/--preset"):
        serve.main(["--device", "cpu", "--arch", "gemma3-1b", "--preset",
                    "reduced", "--checkpoint", lora_checkpoint])


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_encoder_and_prefix_archs_are_refused(arch):
    with pytest.raises(SystemExit, match="text-only archs"):
        serve.main(["--device", "cpu", "--arch", arch])


@no_cuda
def test_default_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--preset", "reduced"])
    cfg = get_reduced("llama3.2-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_cache(cfg, 1, 4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(cfg, params, torch.zeros((1, 2), dtype=torch.int32),
                       2)
