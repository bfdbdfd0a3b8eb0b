"""Federated LM training entry point (the JAX package's ``launch/train.py``):
SCAFFOLD and its baselines on a synthetic federated token stream, in any
update space, with checkpoints.

Runs on the card unless ``--device cpu`` is given. For example, LoRA on
llama3.2-3b at its published widths:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --preset full --update-space lora --lora-rank 8 --rounds 3 \\
      --clients 4 --sampled 2 --local-steps 2 --local-batch 1

``--scan-rounds R`` runs the scanned engine in chunks of up to R rounds
(on the card each round a replay of one captured CUDA graph):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --rounds 8 --log-every 4 --scan-rounds 4 --clients 8 --sampled 2 \
      --local-steps 2 --local-batch 1 --seq-len 64

``--pipeline-depth d`` prepares d rounds ahead while a round runs;
``--store tiered`` keeps the population in host stores behind
``--store-backend`` (dense, memmap, sharded) with ``--prefetch-depth``
chunks of gather-ahead, the scanned engine then holding only the
cohort's rows on the card.

``--async-buffer M`` runs the async buffered engine: one aggregation a
round once M updates land, up to ``--max-inflight`` dispatches in
flight, clients online and late by ``--availability`` (``lognormal``
with ``--latency-sigma``, ``uniform``, ``--dropout``, a recorded
``--availability-trace``), updates weighted by ``--staleness-weighting``
(``--staleness-alpha``, ``--staleness-cutoff``):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --rounds 4 --log-every 2 --async-buffer 2 --max-inflight 4 \
      --availability lognormal --latency-sigma 1.0
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from functools import partial

import numpy as np
import torch

from repro_torch.checkpoint import load_trainer, save_trainer
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedRoundSpec
from repro_torch.core import (
    FederatedTrainer,
    algorithm_names,
    compressor_names,
    get_privatizer,
    availability_names,
    local_solver_names,
    privatizer_names,
    server_optimizer_names,
    staleness_weighting_names,
    store_backend_names,
    update_space_names,
)
from repro_torch.data import SyntheticLMFederated
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.schedules import schedule_names


def preset_config(arch: str, preset: str):
    """``full`` (the published config), ``reduced`` (the CPU-test
    variant) or ``100m`` (a ~100M-parameter member of the family)."""
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "reduced":
        return get_reduced(arch)
    if preset == "100m":
        return dataclasses.replace(
            get_reduced(arch),
            num_layers=12,
            d_model=768,
            num_heads=12,
            num_kv_heads=max(1, min(4, cfg.num_kv_heads)),
            head_dim=64,
            d_ff=3072,
            vocab_size=32768,
            param_dtype="float32",
            compute_dtype="float32",
        )
    raise ValueError(preset)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "100m", "full"])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--loss-chunk-vocab", type=int, default=None,
                    help="cross-entropy over vocab chunks of this size "
                         "(default: the preset's)")
    ap.add_argument("--algorithm", default="scaffold",
                    choices=list(algorithm_names()))
    ap.add_argument("--server-opt", default="",
                    choices=[""] + list(server_optimizer_names()),
                    help="server optimizer ('' = algorithm default)")
    ap.add_argument("--server-momentum", type=float, default=0.0)
    ap.add_argument("--local-solver", default="sgd",
                    choices=list(local_solver_names()),
                    help="client inner optimizer (stateful solvers persist "
                         "per-client slots in the client store)")
    ap.add_argument("--local-momentum", type=float, default=0.9)
    ap.add_argument("--local-beta2", type=float, default=0.99)
    ap.add_argument("--eta-l-schedule", default="",
                    choices=[""] + list(schedule_names()))
    ap.add_argument("--use-megakernel", action="store_true",
                    help="the K-step local loop as one kernel launch where "
                         "the grad/solver combination allows it; others "
                         "fall back per step with a "
                         "megakernel_fallback_reason")
    ap.add_argument("--list-registries", action="store_true",
                    help="print the port's strategy registries and exit")
    ap.add_argument("--update-space", default="",
                    choices=[""] + list(update_space_names()),
                    help="parameter-efficient update space ('' = full): "
                         "the engine trains a delta tree (lora adapters / "
                         "head_only leaves) against frozen base weights")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--lora-alpha", type=float, default=0.0,
                    help="lora scaling alpha (0 = alpha := rank)")
    ap.add_argument("--lora-targets", default="",
                    help="comma-separated fnmatch patterns over parameter "
                         "paths ('' = the dense-matmul defaults for lora; "
                         "required for head_only)")
    ap.add_argument("--weighted", action="store_true",
                    help="paper §2 weighted aggregation by client sizes")
    ap.add_argument("--compress", default="none",
                    choices=list(compressor_names()))
    ap.add_argument("--compress-k", type=int, default=32)
    ap.add_argument("--compress-downlink", default="none",
                    choices=list(compressor_names()))
    ap.add_argument("--privatizer", default="none",
                    choices=list(privatizer_names()))
    ap.add_argument("--clip-norm", type=float, default=0.0)
    ap.add_argument("--noise-multiplier", type=float, default=0.0)
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument("--scan-rounds", type=int, default=0,
                    help="scanned-engine chunk size: run rounds on the device "
                         "in chunks of up to this many (0 = host loop)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="rounds of host inputs prepared ahead while a "
                         "round runs (0 = synchronous)")
    ap.add_argument("--store", default="dense", choices=["dense", "tiered"],
                    help="tiered: the population stays in host stores, "
                         "only cohort rows reach the card")
    ap.add_argument("--store-backend", default="",
                    help="where the population rows live ('' = dense; "
                         "see --list-registries)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="chunks of gather-ahead of the tiered store")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="async buffered aggregation: aggregate once this "
                         "many client updates land (0 = synchronous)")
    ap.add_argument("--max-inflight", type=int, default=0,
                    help="async: dispatches kept in flight (0 = sampled)")
    ap.add_argument("--availability", default="always_on",
                    choices=list(availability_names()),
                    help="async client availability model (seeded, "
                         "virtual time)")
    ap.add_argument("--availability-seed", type=int, default=0,
                    help="seed of the availability model's latency and "
                         "dropout draws (independent of --seed)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-dispatch death probability (uniform, "
                         "lognormal)")
    ap.add_argument("--latency-sigma", type=float, default=1.0,
                    help="lognormal: log-space sigma of a dispatch's "
                         "latency (the straggler tail)")
    ap.add_argument("--availability-trace", default="",
                    help="replay the availability trace at this JSON path "
                         "(--availability trace)")
    ap.add_argument("--staleness-weighting", default="constant",
                    choices=list(staleness_weighting_names()),
                    help="async down-weighting of stale buffered updates")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="polynomial weighting: 1/(1+tau)^alpha")
    ap.add_argument("--staleness-cutoff", type=float, default=10.0,
                    help="cutoff weighting: drop updates staler than this "
                         "many versions")
    ap.add_argument("--resume", default="",
                    help="checkpoint to restore before training")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--sampled", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--eta-l", type=float, default=0.02)
    ap.add_argument("--eta-g", type=float, default=1.0)
    ap.add_argument("--heterogeneity", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="",
                    help="save the trainer here after the last round")
    return ap


def main(argv=None):
    """Parse ``argv``, train, and return the ``FederatedTrainer`` (None
    for ``--list-registries``)."""
    args = _parser().parse_args(argv)

    if args.list_registries:
        for title, names in (
            ("algorithms", algorithm_names()),
            ("server_optimizers", server_optimizer_names()),
            ("compressors", compressor_names()),
            ("local_solvers", local_solver_names()),
            ("store_backends", store_backend_names()),
            ("availability_models", availability_names()),
            ("staleness_weightings", staleness_weighting_names()),
            ("privatizers", privatizer_names()),
            ("update_spaces", update_space_names()),
        ):
            print(f"{title}: {' '.join(names)}")
        return None

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    if args.loss_chunk_vocab is not None:
        cfg = dataclasses.replace(cfg, loss_chunk_vocab=args.loss_chunk_vocab)
    spec = FedRoundSpec(
        algorithm=args.algorithm,
        num_clients=args.clients,
        num_sampled=args.sampled,
        local_steps=args.local_steps,
        local_batch=args.local_batch,
        eta_l=args.eta_l,
        eta_g=args.eta_g,
        server_optimizer=args.server_opt,
        server_momentum=args.server_momentum,
        local_solver=args.local_solver,
        local_momentum=args.local_momentum,
        local_beta2=args.local_beta2,
        eta_l_schedule=args.eta_l_schedule,
        use_megakernel=args.use_megakernel,
        weighted_aggregation=args.weighted,
        compress=args.compress,
        compress_k=args.compress_k,
        compress_downlink=args.compress_downlink,
        privatizer=args.privatizer,
        clip_norm=args.clip_norm,
        noise_multiplier=args.noise_multiplier,
        dp_delta=args.dp_delta,
        update_space=args.update_space,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        update_targets=args.lora_targets,
    )
    data = SyntheticLMFederated(args.clients, cfg.vocab_size, args.seq_len,
                                heterogeneity=args.heterogeneity,
                                seed=args.seed)
    n_params = M.count_params_analytic(cfg)
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M "
          f"algo={args.algorithm} N={args.clients} S={args.sampled} "
          f"K={args.local_steps} b={args.local_batch} device={dev}")

    availability_kwargs = {}
    if args.availability == "trace":
        availability_kwargs["trace"] = args.availability_trace
    elif args.availability != "always_on":
        availability_kwargs.update(seed=args.availability_seed,
                                   dropout=args.dropout)
        if args.availability == "lognormal":
            availability_kwargs["sigma"] = args.latency_sigma
    staleness_kwargs = {}
    if args.staleness_weighting == "polynomial":
        staleness_kwargs["alpha"] = args.staleness_alpha
    elif args.staleness_weighting == "cutoff":
        staleness_kwargs["cutoff"] = args.staleness_cutoff
    trainer = FederatedTrainer(
        partial(M.loss_fn, cfg), partial(M.init_params, cfg, device=dev),
        spec, data, seed=args.seed, use_fused_update=True, device=dev,
        pipeline_depth=args.pipeline_depth, scan_rounds=args.scan_rounds,
        store=args.store, store_backend=args.store_backend,
        prefetch_depth=args.prefetch_depth,
        async_buffer=args.async_buffer, max_inflight=args.max_inflight,
        availability=args.availability,
        availability_kwargs=availability_kwargs,
        staleness_weighting=args.staleness_weighting,
        staleness_kwargs=staleness_kwargs)
    if trainer.update_space.trains_subset:
        n_train = trainer.update_space.num_params(trainer.server.x)
        print(f"update space: {trainer.update_space.name} — "
              f"{n_train/1e6:.3f}M trainable of {n_params/1e6:.1f}M "
              f"({n_params/max(n_train, 1):.0f}x fewer), per-round "
              f"up={trainer._comm_bytes['bytes_up']/1e6:.2f}MB")
    if trainer.async_active:
        eng = trainer.async_engine
        print(f"async engine: aggregate {eng.buffer_size} of "
              f"{eng.max_inflight} in flight, availability="
              f"{args.availability}, staleness={args.staleness_weighting}")
    if trainer.scan_active:
        print(f"scanned engine: on-device chunks of <= {args.scan_rounds} "
              f"rounds")
    if args.privatizer != "none":
        eps = get_privatizer(args.privatizer).epsilon(spec, args.rounds)
        print(f"privatizer: {args.privatizer} clip={args.clip_norm} "
              f"z={args.noise_multiplier} -> epsilon="
              f"{eps:.3f} at delta={args.dp_delta} after "
              f"{args.rounds} rounds")
    if args.use_megakernel:
        reason = trainer.megakernel_fallback_reason
        print("megakernel: fused K-step local loop" if reason == ""
              else f"megakernel: per-step fallback ({reason})")
    if args.store == "tiered":
        print(f"tiered store: population host-side "
              f"({args.store_backend or 'dense'} backend), device peak "
              f"{trainer.client_store_device_bytes()/1e6:.2f}MB of client "
              f"state (gather-ahead depth {args.prefetch_depth})")
    if args.resume:
        load_trainer(args.resume, trainer)
        print(f"resumed from {args.resume} at round {trainer.round_idx}")
    t0 = time.time()
    eval_rng = np.random.default_rng(args.seed + 7)
    eval_batch = data.eval_batch(8, eval_rng, device=dev)
    # log after round 1, then at every log_every boundary
    done = 0
    while done < args.rounds:
        target = (1 if done == 0 else
                  min(args.rounds, (done // args.log_every + 1)
                      * args.log_every))
        trainer.run(target - done)
        done = target
        m = trainer.history[-1]
        with torch.no_grad():
            ev = float(M.loss_fn(cfg, trainer.eval_params(), eval_batch)[0])
        print(f"round {done:4d} loss={m['loss']:.4f} eval={ev:.4f} "
              f"drift={m['drift']:.3e} "
              f"up={m['bytes_up']/1e6:.2f}MB down={m['bytes_down']/1e6:.2f}MB "
              f"({time.time()-t0:.1f}s)", flush=True)
    if args.checkpoint:
        save_trainer(args.checkpoint, trainer)
        print("checkpoint saved to", args.checkpoint)
    return trainer


if __name__ == "__main__":
    main()
