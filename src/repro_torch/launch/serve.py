"""Serving entry point (the JAX package's ``launch/serve.py``): batched decode
against the KV/SSM cache of a text-only model.

The prompt is ingested through decode steps, as the reference does, and
then continued greedily, or sampled with ``--temperature > 0`` from a
``torch.Generator`` seeded by ``--seed``. Runs on the card unless
``--device cpu`` is given; without a card it raises. On the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --preset reduced --batch 2 --prompt-len 8 --max-new 8

On one H100, llama3.2-3b at its published widths:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --preset full --batch 8 --prompt-len 128 --max-new 128

``--checkpoint`` serves a ``repro_torch.launch.train`` checkpoint: the
deltas of a ``lora`` or ``head_only`` update space are merged into the
frozen base once at load (``checkpoint.load_serving_params``), so the
decode path always sees full-shaped weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import load_serving_params
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def checkpoint_params(cfg, path: str, device="cuda"):
    """Merged full parameters from a ``save_trainer`` checkpoint on
    ``device``, held leaf by leaf (paths, shapes, dtypes) to ``cfg``'s
    tree built on the meta device; a mismatch (a wrong ``--arch`` or
    ``--preset``, which would decode garbage) raises ``SystemExit``."""
    params = load_serving_params(path, device=device)
    want = {k: (tuple(v.shape), v.dtype) for k, v in
            M.param_tree(cfg, None, torch.device("meta")).items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    if got != want:
        raise SystemExit(
            f"checkpoint {path!r} does not match --arch/--preset: expected "
            f"{want}, got {got}")
    return params


def _pick(logits, temperature: float, gen):
    """The next token (B, 1) int32 from the last logits (B, V): argmax,
    or with ``temperature > 0`` a draw from softmax(logits / T) by the
    Gumbel-max trick (the reference's ``jax.random.categorical``),
    uniforms from ``gen``; on the device, no host sync."""
    if temperature > 0:
        u = torch.rand(logits.shape, generator=gen, dtype=torch.float32,
                       device=logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        logits = logits.float() / temperature + gumbel
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


@torch.inference_mode()
def generate(cfg, params, prompts, max_new: int, *, temperature: float = 0.0,
             seed: int = 0, device="cuda"):
    """prompts (B, P) integer -> the greedy (or sampled) continuation (B,
    max_new) int32, on ``device`` (the parameters' device; the card
    unless the caller asks for the CPU). The cache holds P + max_new
    tokens; each of the P + max_new steps is one ``decode_step``, in
    inference mode (no autograd bookkeeping: a step is launch-bound)."""
    dev = resolve_device(device)
    b, plen = prompts.shape
    cache = M.init_cache(cfg, b, plen + max_new, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = prompts.to(device=dev, dtype=torch.int32)
    logits = None
    for i in range(plen):
        logits, cache = M.decode_step(
            cfg, params, cache, prompts[:, i:i + 1],
            torch.full((b,), i, dtype=torch.int32, device=dev))
    out = []
    tok = _pick(logits[:, -1], 0.0, gen)
    for i in range(max_new):
        out.append(tok)
        logits, cache = M.decode_step(
            cfg, params, cache, tok,
            torch.full((b,), plen + i, dtype=torch.int32, device=dev))
        tok = _pick(logits[:, -1], temperature, gen)
    return torch.cat(out, dim=1)


@dataclasses.dataclass
class Served:
    """What ``main`` served: the tokens, the parameters, the host seconds
    of ``generate`` (the card synchronised), its decode steps and the
    peak device memory (0 on the CPU)."""

    tokens: torch.Tensor
    params: dict
    seconds: float
    steps: int
    peak_bytes: int

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.seconds / self.steps


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> Served:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "100m", "full"])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--checkpoint", default="",
                    help="serve a launch/train.py checkpoint: deltas of a "
                         "non-full update space (lora/head_only) are "
                         "merged into the frozen base at load time "
                         "('' = fresh random init)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampling generator")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import preset_config

    cfg = preset_config(args.arch, args.preset)
    if cfg.encoder is not None or cfg.num_prefix_tokens:
        raise SystemExit("serve driver targets text-only archs; audio/vlm "
                         "decode is exercised by the dry-run")
    dev = resolve_device(args.device)
    if args.checkpoint:
        params = checkpoint_params(cfg, args.checkpoint, device=dev)
        print(f"serving merged checkpoint {args.checkpoint}")
    else:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.max_new,
                   temperature=args.temperature, seed=args.seed, device=dev)
    _sync(dev)
    served = Served(out, params, time.perf_counter() - t0,
                    args.prompt_len + args.max_new,
                    torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
    ntok = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {served.seconds:.2f}s "
          f"({ntok / served.seconds:.1f} tok/s, {served.ms_per_step:.2f} ms "
          f"a decode step over {served.steps} steps, peak device memory "
          f"{served.peak_bytes / 1e9:.2f} GB)")
    print(out[:, :16].cpu().numpy())
    return served


if __name__ == "__main__":
    main()
