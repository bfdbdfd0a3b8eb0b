#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. environment: card name and power limit, torch/CUDA versions, TF32 off
  2. build: the four CUDA sources from src/repro_torch/kernels/**/csrc
     into build/kernels/, the nvcc processes started together (the
     script goes on once all but local_loop.cu, the slowest, are built,
     and waits for it before phase 5, which runs after phase 12); B5's
     registers, spills and shared memory a block (no spills allowed in
     its tensor-core instantiations)
  3. the fused corrected-step kernel (B1) against its plain version: a
     large leaf, a mixed-dtype tree, and the tree cases of ``B12_CASES``
     (the MLP tree, the 1024 leaf, a 256-leaf group, leaves of 0, 1 and
     62 elements, a misaligned view inside a group), each launched twice
     and bitwise equal, one launch a dtype group
  4. the fused heavy-ball kernel (B2) against its plain version, the same
     cases
  5. the K-step local-loop kernel (B3) against its plain version, A fresh
     and broadcast, resident and streaming (d 3000), each case launched
     twice and bitwise equal; fails if a launch ran on one block
  6. the heavy-ball K-step kernel (B4), the same checks
  7. the sliding-window attention kernel (B5) against its plain version,
     hymba-1.5b's "Y" attention (25q/5kv x 64, window 1024) among the
     shapes; its tensor-core instructions counted in the built library's
     SASS; timed at gemma3-1b's "W" layer and at hymba's beside its bound
     and SDPA, by card time (``card_ms``) and per call (CUDA events)
  8. a 2-layer fp32 llama, one SCAFFOLD round on the card vs the CPU
  9. a 2-layer fp32 gemma3 at seq 128 (its "W" layer through B5), one
     SCAFFOLD round on the card vs the CPU
  10. the gemma3-1b slice: published widths, all 26 layers in bf16, seq
     2048, SCAFFOLD with every "W" layer's attention through B5 and the
     local steps through B1 (2 rounds); launch counts, round times,
     memory and a profiled round
  11. the LM slice: llama3.2-3b widths in bf16, SCAFFOLD through the fused
     update kernel, with its launch count, kernel timing, memory and a
     profiled round
  12. the LM momentum path: the same widths at 10 layers, local
     heavy-ball through B2, the slot rows carried across rounds in the
     solver store, B2 timed at all 28
  13. the quadratics slice: the K-step kernel path and the per-step fused
     path, launch counts, launch plans (more than one block) and
     agreement, a profiled fourth round; B3 timed in both layouts of A
     beside its bound and its grid's K barriers alone
  14. quadratics, heavy-ball (scaffold_m, local momentum): the B4 path and
     the per-step B2 path, launch counts, plans and agreement, B4 timed
  15. quadratics, sgd_sched (cosine) with server adam through B3; local
     adam, fedprox and the head_only update space fall back to the
     per-step path by the reference's reasons (no B3/B4 launch)
  16. the paper's Table 5 (EMNIST-like, the 784-256-62 MLP, N 50, S 10,
     K 25, similarity 0 and 10), its first 15 rounds through the sync
     host loop: SGD, FedAvg and SCAFFOLD, SCAFFOLD's local steps through
     B1; best test accuracy, seconds a round, B1's launches, a profiled
     round; B1 timed at the MLP tree
     (card time beside its empty launch, the plain version and
     ``torch._foreach_add_``; the wrapper's host time a call) and at the
     1024 leaf
  17. compression and privacy on the same MLP, SCAFFOLD, 3 rounds each:
     every uplink codec, int8 both ways, server and distributed Gaussian
     noise over int8, and scaffold_m with local heavy-ball through B2;
     exact bytes, residual rows written and read back, clipped norms,
     the accountant, B2 held against its plain version and timed as B1
     in phase 16, one int8 + server-noise round on the card against the
     CPU, and one heavy-ball round through B2 against the plain update
  18. LoRA on llama3.2-3b at its published widths, 28 layers, bf16,
     through ``repro_torch.launch.train.main``: rank 8 on the default
     targets, SCAFFOLD, N 4, S 2, K 2, seq 256, 3 rounds and a profiled
     fourth; B1 S x K times a round on the one fp32 group of 14 leaves,
     bytes_up/down of the 12,156,928-element delta tree, s/round,
     tokens/s, peak memory; B1 and B2 timed on the tree
  19. LoRA on gemma3-1b at its published widths, 26 layers, seq 2048,
     through the entry point: 3 unbroken rounds; 2 rounds, a checkpoint,
     and a fresh trainer that resumes and runs round 3, bitwise the
     unbroken run; ``load_serving_params`` bitwise the saving trainer's
     ``eval_params()``; B5 on the 22 "W" layers, B1 on the 126-leaf tree
     (timed)
  20. head_only on gemma3-1b (embed, ln_final; bf16), 2 rounds through the
     entry point: B1 on the bf16 2-leaf group (timed), the bytes
  21. the update spaces card against CPU at reduced depth: lora,
     head_only, and lora with local heavy-ball (B2 on the delta tree)
  22. the paper's Figure 3 through the scanned engine, at
     ``benchmarks/fig3_quadratics.py``'s settings (G 1, 10, 100; sgd K 1,
     fedavg and scaffold K 2 and 10; N = S = 2; 60 rounds as one chunk),
     each round a replay of the round's captured CUDA graph; SCAFFOLD
     through B1 and once more through B3, launches counted through the
     replays; the suboptimality table
  23. the paper's Table 5 through the scanned engine, uncut: 150 rounds
     in chunks of 5, accuracy every 5 rounds, B1 150 x S x K times a
     SCAFFOLD row; s/round against phase 16's, the card-busy share of a
     replay; a checkpoint mid-chunk resumed bitwise
  24. B3, B4 (quadratics, d 1024) and B2 (EMNIST heavy-ball) inside
     captured rounds, each trainer bitwise the eager host loop on the
     same device streams
  25. gemma3-1b at its published widths cut to 2 "W" layers, seq 2048,
     ``--scan-rounds 2`` through ``repro_torch.launch.train.main``: B5
     inside the captured round, held to the host loop within 1e-4
  26. the tiered store's scanned engine on the EMNIST MLP at full width
     (N 100, S 5, K 25, chunks of 5: a cohort buffer of 25 rows),
     bitwise the dense engine through B1 (SCAFFOLD) and B2 (scaffold_m,
     int8_ef, local heavy-ball), at gather-ahead depths 1, 2 and 4, over
     the dense, memmap and sharded backends, and resumed from a
     checkpoint; s/round, card-busy share, client-store bytes on the card
  27. population scale: N = 10^6 procedural quadratic clients at d 1024
     (S 64, K 2, chunks of 16), the tiered engine over the dense and
     memmap backends and the dense scanned engine bitwise equal through
     B3 and B4; s/round, each trainer's device and host memory
  28. the pipelined host loop bitwise the synchronous one: gemma3-1b at
     phase 10's settings (B5, B1) at depth 1, and Table 5's EMNIST (6
     rounds) at depth 2 with the stale-row repair counted
  29. the async engine's degenerate limit (M = K = S, always_on,
     constant) bitwise the sync host loop, launches equal: Table 5's
     MLP through B1 (5 aggregations) and scaffold_m + int8_ef + server
     adam + local heavy-ball through B2 (3), phase 13's quadratics
     through B3 and B4 (3 each), gemma3-1b at 26 layers, seq 2048
     through B5 and B1 (2), its peak device memory against the plan
  30. Table 5's MLP through the async engine and B1 under stragglers
     (lognormal sigma 1.5, 20 % dropout, M 5 of K 10, polynomial 0.5),
     20 aggregations: best test accuracy, s/aggregation, the staleness
     histogram, dropped updates, virtual time against the sync loop's,
     a profiled aggregation's busy share; the tiered store (dense and
     memmap backends) and a checkpoint with updates in flight and
     buffered, resumed, bitwise the dense run
  31. gemma3-1b through ``repro_torch.launch.train.main --async-buffer 2
     --max-inflight 3 --availability lognormal``: full space, 3
     aggregations (B5, B1; s/aggregation, peak device memory against the
     plan); LoRA r 8, 2 aggregations and a checkpoint with updates in
     flight, resumed by a fresh process bitwise the unbroken run
  32. the reduced fp32 mamba2 (seq 64) and hymba (seq 128, its attention
     on the band path through B5), one SCAFFOLD round each on the card vs
     the CPU
  33. hymba-1.5b at its published widths, all 32 "Y" layers in bf16, seq
     2048: B5 on every layer's attention (384 launches in 3 rounds), B1
     on the two dtype groups (bf16 weights; fp32 ``a_log``, ``dt_bias``,
     ``d_skip``: 24 launches), s/round and peak memory against
     ``_lm_plan``, B1 timed on the mixed tree; LoRA r 8
     through ``launch.train.main --arch hymba-1.5b --preset full``
  34. mamba2-2.7b at its published widths, all 64 "M" layers in bf16, at
     the longest sequence whose plan fits (seq cut, not depth): B1 on its
     two dtype groups (16 launches in 2 rounds, no B5), s/round and peak
     memory against the plan
  35. the reduced fp32 minitron (untied embeddings, through the
     trainer), paligemma (16 patches under the prefix mask) and whisper
     (encoder over 64 frames, cross-attention), one SCAFFOLD round each
     on the card vs the CPU, the latter two through ``federated_round``
     with their stub inputs; ``flash_attention`` (plain PyTorch, no
     kernel) on the card vs the CPU at S 3072 under each mask
  36. minitron-4b at its published widths (two 0.79e9 vocab tables),
     bf16, seq 2048: ``head_only`` on ``unembed*,ln_final*`` at all 32
     layers through ``launch.train.main`` (B1 8), then the full space
     through the trainer at the depth ``_lm_plan`` admits, logged as a
     cut (B1 8 in 2 rounds)
  37. paligemma-3b at its published widths, 18 layers, bf16, 256
     projected patches + 1792 text tokens (the dense prefix-LM path),
     the full space through ``federated_round``: B1 12, no B5
  38. gemma3-1b at 26 layers, seq 4096: the 22 "W" layers through B5
     (264 launches in 3 rounds), the 4 "F" layers through
     ``flash_attention``, B1 12
  39. whisper-tiny at its published widths (4 + 4 layers, fp32), 1500
     frames and 448 text tokens, batch 4, the full space through
     ``federated_round``: B1 12 on the one fp32 group
  40. every ported family's reduced fp32 config (llama, gemma3 and hymba
     past their windows, mamba2, minitron, whisper, paligemma,
     minicpm3, qwen2-moe and deepseek-v3 under the ragged dispatch):
     ``decode_step`` on the card against the CPU within 1e-4 and
     against ``prefill`` on the card within 5e-4; B5 on the prefills'
     band layers, no kernel of B1-B5 in decode, the fp32 grouped product
     G1 3 a MoE layer a step; the MoE pair's gshard federated round on
     the card against the CPU (B1), the ragged block against gshard at
     capacity factor 8 on the card, and G1 against its plain version
     (forward and both gradients), timed beside fp32
     ``torch._grouped_mm``
  41. gemma3-1b at its published widths, 26 layers, bf16: ``prefill`` at
     batch 2 x 1024 (B5 22, one a "W" layer), the first 576 of the same
     tokens through ``decode_step`` (the 512-slot rings wrap), the last
     64 decoded positions within ``BF16_DECODE_BOUND`` of the prefill;
     ``generate`` 64 new tokens: ms a step, tokens/s, peak memory
  42. ``repro_torch.launch.serve.main --preset full --batch 8
     --prompt-len 64 --max-new 32`` for llama3.2-3b, minitron-4b,
     mamba2-2.7b and hymba-1.5b; mamba2 and hymba in fp32, prefill (the
     chunked SSD) against decode (its recurrence) at 64 tokens
  43. phase 19's LoRA checkpoint through ``serve.main --checkpoint``:
     "serving merged checkpoint", the params bitwise
     ``load_serving_params``'; a mismatched ``--arch`` refused
  44. whisper-tiny: ``populate_encoder_cache`` over 1500 frames and 448
     decode steps against the teacher-forced forward (fp32, 5e-4);
     paligemma-3b: 16 decode steps at its published widths, finite
  45. minicpm3-4b (MLA) through ``launch.train.main``: LoRA r 8 at 62
     layers at the sequence the plan admits (B1); the full space at the
     depth ``_lm_plan`` admits, at most 24 layers (B1), the trained
     model's absorbed MLA
     decode against its prefill at 128 tokens
  46. qwen2-moe-a2.7b at its published widths, bf16, seq 2048 (the
     ragged dispatch, ``torch._grouped_mm``): LoRA r 8 on the default
     targets (4-D expert adapters) through ``launch.train.main`` at the
     depth ``_lm_plan`` admits (B1 8); the full space through the
     trainer at its cut depth (B1 8), a profiled round, B1 timed on
     its tree
  47. ``serve.main --arch qwen2-moe-a2.7b --preset full --batch 8
     --prompt-len 128 --max-new 64`` at 24 layers; phase 46's LoRA
     model merged, its decode against its prefill at 256 tokens in bf16
     within 0.1 at every position, the decode's routing pinned to the
     prefill's (the flips it would make counted)
  48. deepseek-v3-671b at its published widths cut to 3 dense + 1 MoE
     layer (256 experts, top 8, MLA), bf16, LoRA r 8 without the routed
     experts through ``launch.train.main`` (B1 8), its MLA + MoE decode
     against its prefill as in 47
  49. the dry-run census (``repro_torch.launch.census``) on the card:
     gemma3-1b x train_4k at its published widths (26 layers, bf16, seq
     4096, S 16, K 4 and b 4 of ``default_round_spec``), local_batch
     then S cut to the largest the census puts within
     ``LM_MEMORY_LIMIT``; that round run for real (B1 and B5), its
     ``max_memory_allocated`` within ``CENSUS_MEMORY_BOUND`` of the
     census's peak (``_lm_plan``'s figure logged beside), its launches
     equal to the census's, the census's flops over the round's wall
     time as a share of 989 TFLOP/s; gemma3-1b x decode_32k (batch 128,
     caches at 32768) the same way with one ``decode_step``; census
     only for llama3.2-3b and qwen2-moe-a2.7b x train_4k. The censuses
     (host-bound) run in a process of their own (``census_job``, one
     thread at the lowest priority), started after phase 2's wait,
     beside the phases that follow: each logs beside its time that it
     overlapped the job. The job's fake CUDA tensors open a CUDA
     context on the card (PyTorch's ``FakeTensorMode`` allocates one
     element to do so), which allocates nothing else

Every decode of phases 40-48 runs under
``torch.cuda.set_sync_debug_mode("error")``: a host sync fails it.
Every LM phase logs its memory plan (``_lm_plan``) against its measured
peak. A profiled round records the CUDA activity alone; the profiler's
own seconds are logged after each and summed at the end. Each main path runs with every launch count set to 0 just before it and
read just after; a launch inside a captured CUDA graph counts at each
replay. Every kernel's ``launches`` in the kernels line sums the paths
that run it (``launches_by_path``), the scanned ones included.

It prints the ``kernels`` JSON line, the card's name and power limit, and
last the ``{"ok": true, "device": ...}`` line. It imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import time
import warnings
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # long records (git-ignored)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# bytes the LM phases may plan to hold on the card (80 GiB on an H100 80GB).
# _lm_plan over-reckons what they hold: 60.0 GB planned vs 55.87 GB at 28
# layers without a slot, 70.6 vs 67.91 GB at 27 layers with the fp32 slot
# (H100 80GB HBM3, 700 W), so a 75 GB plan holds ~72 GB
LM_MEMORY_LIMIT = 75e9
# bytes of client-state rows the LM phases may plan to hold in host memory
# (the machine with one card has 96 GiB)
HOST_MEMORY_LIMIT = 85e9
# B4 vs plain, bf16 y: m_K's and the losses' bound in a case where y's
# bf16 rounding flipped (1.52e-4 and 6.57e-4 the largest on an H100 80GB
# HBM3, 700 W; 3x room)
B4_FLIPPED_BOUND = 2e-3
# B3 vs plain, bf16 y: the losses' bound in a case where y's bf16 rounding
# flipped (2.72e-4 the largest, its first flip, on the cooperative grid:
# bf16 y, fp32 A,b, H100 80GB HBM3, 700 W; 3x room)
B3_FLIPPED_BOUND = 8.2e-4
# (d, K, bsz) of B3's and B4's checks: the JAX package's widths, the
# trainer's d 1024, and one width past the resident slabs (both layouts
# stream at d 3000, in three column chunks)
LOOP_SHAPES = tuple((d, K, bsz) for d in (20, 1000, 1024) for K in (1, 10)
                    for bsz in (1, 2)) + ((3000, 2, 2),)
# the kernel source whose nvcc takes longest (45-49 s alone on the H100
# machine): it builds alongside the phases before B3's check
SLOW_BUILD = "local_loop"
B1_REPLACES = "src/repro/kernels/scaffold_update/kernel.py:46"
B2_REPLACES = "src/repro/kernels/scaffold_update/kernel.py:73"
B3_REPLACES = "src/repro/kernels/scaffold_update/megakernel.py:108"
B4_REPLACES = "src/repro/kernels/scaffold_update/megakernel.py:141"
B5_REPLACES = "src/repro/kernels/swa_attention/kernel.py:70"
# the fp32 grouped product of the routed experts stands where the JAX
# package's moe_block_ragged calls lax.ragged_dot (XLA, not a Pallas
# kernel)
G1_REPLACES = "src/repro/models/layers.py:545"
SOURCES = {"update": "src/repro_torch/kernels/scaffold_update/csrc/"
                     "scaffold_update.cu",
           "loop": "src/repro_torch/kernels/scaffold_update/csrc/"
                   "local_loop.cu",
           "swa": "src/repro_torch/kernels/swa_attention/csrc/"
                  "swa_attention.cu",
           "grouped": "src/repro_torch/kernels/grouped_mm/csrc/"
                      "grouped_mm.cu"}
# H100 SXM dense bf16 tensor-core rate, and fp32 outside the tensor cores
# (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# B5 vs plain in fp32: max abs error (the JAX package's own kernel bound,
# tests/test_kernels.py); in bf16 the bound is 1 bf16 ulp of the plain
# element plus this (both round an fp32 result once, and the two fp32
# results differ by their summation order, ~1e-6, which exceeds an ulp
# only for elements below 2^-8)
B5_FP32_ATOL = 2e-5
# (B, S, Hq, Hkv, D, window): the JAX package's kernel test shapes,
# gemma3-1b's "W" layer at seq 2048, batch 1 and 2, and the bf16 kernel's
# tiling edges: S and W not multiples of its 64-row tiles, W >= S, batch 2
# with 4 query heads a kv head; hymba-1.5b's "Y" layer's attention at seq
# 2048 (25 query heads over 5 kv heads, window 1024), batch 1 and 2
B5_CASES = ((1, 512, 2, 1, 64, 128), (2, 256, 4, 4, 32, 64),
            (1, 384, 6, 3, 64, 128), (2, 128, 2, 1, 128, 64),
            (1, 2048, 4, 1, 256, 512), (2, 2048, 4, 1, 256, 512),
            (1, 1000, 4, 1, 256, 300), (1, 1000, 4, 1, 64, 300),
            (1, 300, 4, 1, 256, 512), (1, 200, 2, 1, 32, 50),
            (2, 512, 4, 1, 256, 128), (2, 1000, 8, 2, 64, 300),
            (1, 2048, 25, 5, 64, 1024), (2, 2048, 25, 5, 64, 1024))
B5_LAYER = B5_CASES[4]  # gemma3-1b's "W" layer at batch 1, the timed shape
B5_HYMBA = B5_CASES[12]  # hymba-1.5b's "Y" attention at batch 1, timed too
# B1's and B2's tree cases, name -> (leaf sizes, dtype of y and g, dtype
# of corr, misaligned leaves): the trees the main path launches them on
# (the EMNIST MLP's, the quadratics' one leaf), a full leaf table (corr
# fp32 as the trainer's, and bf16), a group with empty and tiny leaves,
# and a view 4 B past an aligned base inside a group (its chunks take the
# scalar path). tests/test_torch_kernels_gpu.py runs the same cases.
B12_CASES = {
    "mlp tree": ((784 * 256, 256, 256 * 62, 62), "float32", "float32", ()),
    "1024 leaf": ((1024,), "float32", "float32", ()),
    "256 leaves": (tuple(1 + (i * 131) % 4099 for i in range(256)),
                   "bfloat16", "float32", ()),
    "256 leaves, bf16 corr": (tuple(1 + (i * 131) % 4099
                                    for i in range(256)),
                              "bfloat16", "bfloat16", ()),
    "0, 1, 62 elements": ((0, 1, 62, 4101), "float32", "float32", ()),
    "misaligned view in a group": ((5000, 3001, 62), "float32", "float32",
                                   (1,)),
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 and forget the K-step loops'
    launch plans."""
    from repro_torch.kernels.grouped_mm import ops as gmm_ops
    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    ops.reset_launches()
    swa_ops.reset_launches()
    gmm_ops.reset_launches()
    mk.reset_plans()


def launches() -> dict:
    """Every kernel's launch count since the last reset, by name."""
    from repro_torch.kernels.grouped_mm import ops as gmm_ops
    from repro_torch.kernels.scaffold_update import ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    return {**ops.LAUNCHES, **swa_ops.LAUNCHES, **gmm_ops.LAUNCHES}


def log(msg: str) -> None:
    """Print one line of the run's record, flushed."""
    print(msg, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, flush=None) -> float:
    """Mean milliseconds of ``fn()`` on the card by CUDA events, after one
    warm-up call; with ``flush`` (a large tensor) the L2 cache is
    overwritten before every timed call and only the call is timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def card_ms(fn, iters: int, flush, spin: int) -> float:
    """Mean milliseconds the card spends on one ``fn()`` by CUDA events,
    after one warm-up call: before each call ``flush.zero_()`` overwrites
    the L2 cache and the stream then spins ``spin`` clock cycles
    (``torch.cuda._sleep``), so that the host has queued the whole call
    before the card reaches the first event and the events time the
    card's work (with its launch gaps), not the host's. (torch.profiler's
    kernel durations, read here before, lost launches and then whole
    sessions in some runs on an H100.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def in_turns(kernel, plain, turns: int, k_iters: int, p_iters: int,
             flush=None):
    """Kernel and plain version timed in alternating turns (plain,
    kernel, kernel, plain, ...), each turn a ``cuda_ms`` mean; returns
    the two lists of per-turn ms."""
    k_all, p_all = [], []
    for turn in range(turns):
        for side in (("plain", "kernel") if turn % 2 == 0
                     else ("kernel", "plain")):
            if side == "kernel":
                k_all.append(cuda_ms(kernel, k_iters, flush=flush))
            else:
                p_all.append(cuda_ms(plain, p_iters, flush=flush))
    return k_all, p_all


def spread(ms) -> str:
    """``median ms (min-max over n turns)``."""
    return (f"{statistics.median(ms):.4f} ms ({len(ms)} turns, "
            f"{min(ms):.4f}-{max(ms):.4f})")


def host_peak_gb() -> float:
    """Peak resident host memory of this process, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def ulp_distance(a, b):
    """Max distance in units of the last place between two like tensors
    of one float dtype (fp32 or bf16)."""
    import torch

    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    bits = 31 if a.dtype == torch.float32 else 15
    fa, fb = a.contiguous().view(ity).reshape(-1), \
        b.contiguous().view(ity).reshape(-1)
    worst = 0
    # in chunks: the int64 copies of a 0.79e9-element leaf would take 25 GB
    for lo in range(0, fa.numel(), 1 << 26):
        ia = fa[lo:lo + (1 << 26)].long()
        ib = fb[lo:lo + (1 << 26)].long()
        # map the sign-magnitude encoding onto a monotone integer line
        ia = torch.where(ia < 0, -(ia & ((1 << bits) - 1)), ia)
        ib = torch.where(ib < 0, -(ib & ((1 << bits) - 1)), ib)
        worst = max(worst, int((ia - ib).abs().max()))
    return worst


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def bf16_ulps(x):
    """Elementwise spacing of bf16 numbers at |x|, as fp32."""
    import torch

    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(2.0 ** -126))) - 7)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment():
    """Phase 1: the card, the versions, TF32 off."""
    import torch

    smi = nvidia_smi()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ("
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB), "
        f"{torch.cuda.device_count()} device(s); allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    """Phase 2: build every kernel source, the nvcc processes started
    together. The script goes on once all but ``SLOW_BUILD`` are built;
    that one (B3/B4's source, the longest compile) builds alongside the
    phases that do not run it, and ``phase_build_wait`` waits for it
    before B3's check. Returns what ``phase_build_wait`` takes."""
    import threading

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    errors = []

    def slow():
        try:
            build.build([SLOW_BUILD])
        except RuntimeError as e:
            errors.append(e)

    worker = threading.Thread(target=slow, daemon=True)
    worker.start()
    rest = sorted(n for n in build.SOURCES if n != SLOW_BUILD)
    build.build(rest)
    log(f"build: {rest} in {time.perf_counter() - t0:.1f} s wall "
        f"({SLOW_BUILD} building alongside), into {build.BUILD_DIR}")
    logs = _log_ptxas(rest)
    smem = build.load("swa_attention").swa_attention_smem_bytes
    report = ptxas_report(logs["swa_attention"])
    spilled = []
    for fn, r in sorted(report.items()):
        dtype = 1 if fn.startswith("swa_fwd_wgmma") else 0
        d = int(fn[fn.index("<") + 1:-1])
        log(f"  B5 {fn}: {r['registers']} registers, {r['spill_stores']} B "
            f"spill stores, {r['spill_loads']} B spill loads, "
            f"{smem(dtype, d)} B dynamic shared memory a block")
        if dtype == 1 and (r["spill_stores"] or r["spill_loads"]):
            spilled.append(fn)
    if sorted(report) != sorted(f"swa_fwd_{kind}<{d}>" for kind in
                                ("wgmma", "simt") for d in (32, 64, 128, 256)):
        raise AssertionError(f"B5 ptxas report: functions {sorted(report)}")
    if spilled:
        raise AssertionError(f"B5 tensor-core kernels spill: {spilled}")
    return worker, errors, t0


def phase_build_wait(pending):
    """The end of phase 2: wait for ``SLOW_BUILD``'s nvcc (raises with
    its output if it failed) and log its ptxas report."""
    worker, errors, t0 = pending
    worker.join()
    if errors:
        raise errors[0]
    log(f"build: {SLOW_BUILD} built {time.perf_counter() - t0:.1f} s after "
        f"the build began")
    _log_ptxas([SLOW_BUILD])


def _log_ptxas(names) -> dict:
    """Log each built library's kernel count and first register line,
    append its ptxas report to ``OUT/ptxas.txt``; returns the reports."""
    from repro_torch.kernels import build

    logs = {name: build.ptxas_log(name) for name in names}
    for name, out in logs.items():
        used = [ln.strip() for ln in out.splitlines() if "Used" in ln]
        log(f"  ptxas {name}: {len(used)} kernels, e.g. "
            f"{used[0] if used else 'no ptxas report'}")
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "ptxas.txt", "a") as f:
        f.write("".join(f"== {name}\n{out}" for name, out in logs.items()))
    return logs


def ptxas_report(out: str) -> dict:
    """Registers and spill bytes of each B5 kernel function in an
    ``-Xptxas -v`` log, by ``swa_fwd_<kind><D>``."""
    report, fn = {}, None
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '.*?(swa_fwd_\w+?)ILi(\d+)E",
                      ln)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
            report[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            report[fn].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            report[fn]["registers"] = int(m.group(1))
    return report


def sass_tensor_core_counts(lib: Path) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) of each B5 kernel function
    in a built library's SASS (``cuobjdump -sass``), by function."""
    from repro_torch.kernels import build

    sass = subprocess.run([build.toolkit("cuobjdump"), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"(swa_fwd_\w+?)ILi(\d+)E", part.split("\n", 1)[0])
        if m:
            counts[f"{m.group(1)}<{m.group(2)}>"] = dict(
                HGMMA=len(re.findall(r"\bHGMMA\.", part)),
                HMMA=len(re.findall(r"\bHMMA\.", part)))
    return counts


def _check_b12_cases(momentum: bool) -> None:
    """Every case of ``B12_CASES`` through B1 (B2 with ``momentum``),
    launched twice into fresh outputs: the two runs bitwise equal, one
    launch each, y' within 0 ulp of the plain version in fp32 and 1 in
    bf16, m' within 0 ulp."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    name = "scaffold_momentum_update" if momentum else "scaffold_update"
    gen = torch.Generator(device="cuda").manual_seed(13)
    for case, (sizes, dtype, corr_dtype, views) in B12_CASES.items():
        dt, ct = getattr(torch, dtype), getattr(torch, corr_dtype)
        trees = [{}, {}, {}, {}]
        for i, n in enumerate(sizes):
            for t, tdt in zip(trees, (dt, dt, ct, torch.float32)):
                base = torch.randn(n + 1, generator=gen, device="cuda").to(tdt)
                t[f"l{i}"] = base[1:] if i in views else base[:n].clone()
        y, g, c, m = trees
        runs, n_launch = [], []
        for _ in range(2):
            before = ops.LAUNCHES[name]
            if momentum:
                runs.append(ops.scaffold_momentum_update_packed(
                    y, g, c, m, 0.3, 0.9))
            else:
                runs.append((ops.scaffold_update_packed(y, g, c, 0.3), {}))
            n_launch.append(ops.LAUNCHES[name] - before)
        torch.cuda.synchronize()
        same = all(torch.equal(a[k], b[k]) for a, b in zip(*runs)
                   for k in a)
        if momentum:
            want_y, want_m = ref.scaffold_momentum_update_tree_ref(
                y, g, c, m, 0.3, 0.9)
        else:
            want_y = {k: ref.scaffold_update_ref(y[k], g[k], c[k], 0.3)
                      for k in y}
            want_m = {}
        uy = max((ulp_distance(runs[0][0][k], want_y[k]) for k in y
                  if y[k].numel()), default=0)
        um = max((ulp_distance(runs[0][1][k], want_m[k]) for k in want_m
                  if y[k].numel()), default=0)
        (plan,) = ops.plans(y, g, c, m if momentum else None)
        log(f"{name} {case} ({len(sizes)} leaves, {sum(sizes)} {dtype}): "
            f"grid {plan.grid} over {plan.first[-1]} chunks of {ops.CHUNK}, "
            f"table of {plan.capacity}; launches {n_launch}; two runs "
            f"{'bitwise equal' if same else 'DIFFER'}; worst leaf {uy} ulp "
            f"in y'" + (f", {um} in m'" if momentum else ""))
        if (not same or n_launch != [1, 1] or uy > (dt == torch.bfloat16)
                or um > 0 or not 1 <= plan.grid <= plan.first[-1]):
            raise AssertionError(f"{name} {case} failed")


def phase_b1_plain():
    """Phase 3: the fused update kernel against its plain version."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    eta = 0.05
    for dtype in (torch.float32, torch.bfloat16):
        n = 1_000_003
        y, g, c = (torch.randn(n, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        out = ops.scaffold_update(y, g, c, eta)
        plain = ref.scaffold_update_ref(y, g, c, eta)
        torch.cuda.synchronize()
        ulp = ulp_distance(out, plain)
        log(f"scaffold_update n={n} {dtype}: max |kernel - plain| = "
            f"{float((out.float() - plain.float()).abs().max()):.3e}, "
            f"{ulp} ulp (bound 1 ulp of {dtype})")
        if ulp > 1:
            raise AssertionError(f"scaffold_update {dtype}: {ulp} ulp")
    # a mixed-dtype tree of odd sizes, updated in place: one launch per
    # (y, g, corr) dtype group
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {"a": (bf16, bf16, bf16, 4099), "b": (f32, bf16, f32, 77),
             "c": (f32, f32, f32, 100_003), "d": (bf16, bf16, bf16, 9),
             "e": (f32, bf16, f32, 1 << 16)}
    y, g, c = {}, {}, {}
    for k, (ty, tg, tc, n) in kinds.items():
        y[k] = torch.randn(n, generator=gen, device="cuda").to(ty)
        g[k] = torch.randn(n, generator=gen, device="cuda").to(tg)
        c[k] = torch.randn(n, generator=gen, device="cuda").to(tc)
    groups = len({v[:3] for v in kinds.values()})
    work = {k: v.clone() for k, v in y.items()}
    before = ops.LAUNCHES["scaffold_update"]
    ops.scaffold_update_packed(work, g, c, eta, out=work)
    n_launch = ops.LAUNCHES["scaffold_update"] - before
    torch.cuda.synchronize()
    worst = max(ulp_distance(work[k],
                             ref.scaffold_update_ref(y[k], g[k], c[k], eta))
                for k in y)
    log(f"scaffold_update_packed mixed tree, in place: {groups} dtype groups,"
        f" {n_launch} launches, worst leaf {worst} ulp (bound 1)")
    if n_launch != groups or worst > 1:
        raise AssertionError("scaffold_update_packed mixed tree failed")
    _check_b12_cases(momentum=False)


def phase_b2_plain():
    """Phase 4: the fused heavy-ball kernel against its plain version."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    eta, beta, n = 0.05, 0.9, 1_000_003
    for dtype in (torch.float32, torch.bfloat16):
        y, g, c = (torch.randn(n, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        m = torch.randn(n, generator=gen, device="cuda")
        yo, mo = ops.scaffold_momentum_update(y, g, c, m, eta, beta)
        yp, mp = ref.scaffold_momentum_update_ref(y, g, c, m, eta, beta)
        torch.cuda.synchronize()
        uy, um = ulp_distance(yo, yp), ulp_distance(mo, mp)
        log(f"scaffold_momentum_update n={n} y {dtype}, m fp32: worst "
            f"{uy} ulp in y', {um} ulp in m' (bounds 1 and 0 ulp)")
        if uy > 1 or um > 0:
            raise AssertionError(f"scaffold_momentum_update {dtype}: "
                                 f"{uy}/{um} ulp")
    # a mixed-dtype tree of odd sizes, y and m updated in place: one
    # launch per (y, g, corr, m) dtype group
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {"a": (bf16, bf16, bf16, 4099), "b": (f32, bf16, f32, 77),
             "c": (f32, f32, f32, 100_003), "d": (bf16, bf16, bf16, 9),
             "e": (f32, bf16, f32, 1 << 16)}
    y, g, c, m = {}, {}, {}, {}
    for k, (ty, tg, tc, size) in kinds.items():
        y[k] = torch.randn(size, generator=gen, device="cuda").to(ty)
        g[k] = torch.randn(size, generator=gen, device="cuda").to(tg)
        c[k] = torch.randn(size, generator=gen, device="cuda").to(tc)
        m[k] = torch.randn(size, generator=gen, device="cuda")
    groups = len({v[:3] for v in kinds.values()})
    want_y, want_m = ref.scaffold_momentum_update_tree_ref(y, g, c, m, eta,
                                                           beta)
    before = ops.LAUNCHES["scaffold_momentum_update"]
    ops.scaffold_momentum_update_packed(y, g, c, m, eta, beta, out=y,
                                        m_out=m)
    n_launch = ops.LAUNCHES["scaffold_momentum_update"] - before
    torch.cuda.synchronize()
    uy = max(ulp_distance(y[k], want_y[k]) for k in y)
    um = max(ulp_distance(m[k], want_m[k]) for k in y)
    log(f"scaffold_momentum_update_packed mixed tree, in place: {groups} "
        f"dtype groups, {n_launch} launches, worst leaf {uy} ulp in y', "
        f"{um} ulp in m' (bounds 1 and 0)")
    if n_launch != groups or uy > 1 or um > 0:
        raise AssertionError("scaffold_momentum_update_packed mixed tree "
                             "failed")
    _check_b12_cases(momentum=True)


def _b3_inputs(gen, d, K, bsz, ty, tab):
    import torch

    y = torch.randn(d, generator=gen, device="cuda").to(ty)
    corr = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(ty)
    A = (torch.randn((K, bsz, d, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(tab)
    b = torch.randn((K, bsz, d), generator=gen, device="cuda").to(tab)
    eta = torch.linspace(0.1, 0.05, K, device="cuda")
    return y, corr, eta, A, b


def _plans(name: str) -> str:
    """The plans kernel ``name`` launched since the last reset, one
    ``grid x rows, chunk, resident|streaming: launches``
    each; raises if one of them is a single block."""
    from repro_torch.kernels.scaffold_update import megakernel as mk

    plans = mk.PLANS[name]
    one = [p for p in plans if p.grid < 2]
    if not plans or one:
        raise AssertionError(f"{name}: plans {dict(plans)}; a launch on "
                             f"one block (or none launched)")
    return "; ".join(
        f"d {p.d}: {p.grid} blocks x {p.rows} rows, chunk {p.chunk}, "
        + ("resident" if p.resident else "streaming")
        + f", {p.smem_bytes} B shared: x{n}"
        for p, n in sorted(plans.items(), key=lambda t: (t[0].d,
                                                         t[0].resident)))


def _check_local_loop(name, seed, tabs, beta, flipped_bound):
    """B3 (``beta`` None) or B4 against its plain version in y fp32/bf16 x
    A,b dtypes ``tabs`` x LOOP_SHAPES x A fresh/broadcast, each launched
    twice (bitwise equal); returns the largest errors of m_K and losses in
    the cases whose bf16 y_K shows a flipped rounding."""
    import torch

    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    outs = ("y_K", "losses") if beta is None else ("y_K", "m_K", "losses")
    lines, failed, flipped_worst = [], [], [0.0] * (len(outs) - 1)
    reset_launches()
    for ty in (f32, bf16):
        for tab in tabs:
            worst, flipped, n = [0.0] * len(outs), 0, 0
            for d, K, bsz in LOOP_SHAPES:
                y, corr, eta, A, b = _b3_inputs(gen, d, K, bsz, ty, tab)
                kw = {} if beta is None else dict(
                    m=torch.randn(d, generator=gen, device="cuda"),
                    beta=beta)
                layouts = {"fresh": (A, b), "broadcast": (
                    A[:1, :1].expand(K, bsz, d, d),
                    b[:1, :1].expand(K, bsz, d))}
                for layout, (AA, bb) in layouts.items():
                    got = mk.scaffold_local_loop_cuda(y, corr, eta, AA, bb,
                                                      **kw)
                    again = mk.scaffold_local_loop_cuda(y, corr, eta, AA, bb,
                                                        **kw)
                    want = ref.scaffold_local_loop_ref(y, corr, eta, AA, bb,
                                                       **kw)
                    torch.cuda.synchronize()
                    got, again, want = ([t for t in r if t is not None]
                                        for r in (got, again, want))
                    same = all(torch.equal(a, c) for a, c in zip(got, again))
                    # fp32 y: summation order only, 1e-5. bf16 y is rounded
                    # to bf16 every step from fp32 values that differ by
                    # the summation order (~1e-7 relative), so a rounding
                    # rarely flips: y_K then differs by up to 2 bf16 ulps
                    # at max|y|, and every later g, hence m_K and the
                    # losses, moves too. A case with no flip (y_K equal)
                    # holds them to 1e-5; a flipped case takes
                    # ``flipped_bound``.
                    scale = float(want[0].float().abs().max())
                    bound = (1e-5 if ty == f32
                             else 2 * bf16_ulp(scale) / scale)
                    errs = [rel_err(g, w) for g, w in zip(got, want)]
                    flip = ty == bf16 and errs[0] > 0
                    bound_rest = flipped_bound if flip else 1e-5
                    flipped += flip
                    n += 1
                    if flip:
                        flipped_worst = [max(w, e) for w, e in
                                         zip(flipped_worst, errs[1:])]
                    lines.append(
                        f"d={d} K={K} bsz={bsz} y {ty} A,b {tab} {layout}: "
                        + ", ".join(f"{o} {e:.2e}" for o, e in
                                    zip(outs, errs))
                        + f" (bounds y_K {bound:.2e}, rest {bound_rest:.2g}"
                        + f"{', y_K flipped' if flip else ''}); two runs "
                        + ("bitwise equal" if same else "DIFFER"))
                    if errs[0] > bound or max(errs[1:]) > bound_rest or (
                            not same):
                        failed.append(lines[-1])
                    worst = [max(w, e) for w, e in zip(worst, errs)]
            log(f"{name} y {ty} A,b {tab}"
                f"{'' if beta is None else f', beta {beta}'}: {n} cases "
                f"({len(LOOP_SHAPES)} d/K/bsz shapes x A fresh/broadcast),"
                f" each launched twice, bitwise equal; worst rel err "
                + ", ".join(f"{o} {w:.2e}" for o, w in zip(outs, worst))
                + " (bounds "
                + ("1e-5 for all)" if ty == f32 else
                   f"y_K 2 bf16 ulps of max|y|; the rest 1e-5, "
                   f"{flipped_bound:.2g} in the {flipped} of {n} cases whose"
                   f" y_K shows a flipped bf16 rounding)"))
    log(f"{name} plans: {_plans(name)}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}_cases.txt").write_text("\n".join(lines) + "\n")
    if failed:
        raise AssertionError("; ".join(failed))
    return flipped_worst


def phase_b3_plain():
    """Phase 5: the K-step loop kernel against its plain version."""
    import torch

    worst = _check_local_loop("scaffold_local_loop", 2,
                              (torch.float32, torch.bfloat16), None,
                              B3_FLIPPED_BOUND)
    log(f"scaffold_local_loop: largest losses error in a flipped bf16 case "
        f"{worst[0]:.2e} (bound {B3_FLIPPED_BOUND:.2g})")


def phase_b4_plain():
    """Phase 6: the heavy-ball K-step loop kernel against its plain
    version."""
    import torch

    worst = _check_local_loop("scaffold_momentum_local_loop", 6,
                              (torch.float32,), 0.9, B4_FLIPPED_BOUND)
    log(f"scaffold_momentum_local_loop: largest m_K, losses errors in a "
        f"flipped bf16 case {worst[0]:.2e}, {worst[1]:.2e} (bound "
        f"{B4_FLIPPED_BOUND:.2g})")


def _swa_inputs(gen, b, s, hq, hkv, d, dtype):
    import torch

    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(
        dtype) for _ in range(2))
    return q, k, v


def _swa_plain(q, k, v, window):
    """B5's plain version in the op's layout (B, S, H, D)."""
    from repro_torch.kernels.swa_attention import ref

    return ref.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window).transpose(1, 2)


def phase_b5_plain(result):
    """Phase 7: the sliding-window attention kernel against its plain
    version (bf16: 1 ulp where |plain| >= 2^-8, 1 ulp + B5_FP32_ATOL
    everywhere); the tensor-core instructions of its SASS counted; timed
    at gemma3-1b's "W" layer and hymba-1.5b's "Y" attention beside its
    bound, its plain version and SDPA with the band mask, by device time
    and per call."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention import ops as swa_ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    f32, bf16 = torch.float32, torch.bfloat16
    lines, failed = [], []
    for dtype in (f32, bf16):
        worst, worst_case, worst_ulp, n_small = 0.0, None, 0.0, 0
        for case in B5_CASES:
            b, s, hq, hkv, d, w = case
            q, k, v = _swa_inputs(gen, b, s, hq, hkv, d, dtype)
            got = swa_ops.swa_attention_cuda(q, k, v, w)
            want = _swa_plain(q, k, v, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            e_max = float(err.max())
            if dtype == f32:
                ok = e_max <= B5_FP32_ATOL
                note = f"bound {B5_FP32_ATOL:.0e}"
            else:
                ulp = bf16_ulps(want)
                big = want.float().abs() >= 2.0 ** -8
                e_ulp = float((err[big] / ulp[big]).max()) if big.any() else 0.
                ok = bool((err <= ulp + B5_FP32_ATOL).all()) and e_ulp <= 1
                small = int((err > ulp).sum())
                worst_ulp, n_small = max(worst_ulp, e_ulp), n_small + small
                note = (f"{e_ulp:.0f} ulp at most where |plain| >= 2^-8; "
                        f"{small} smaller elements beyond 1 ulp; bound 1 ulp"
                        f" + {B5_FP32_ATOL:.0e}")
            lines.append(f"B5 {case} {dtype}: max |kernel - plain| "
                         f"{e_max:.3e} ({note})")
            if not ok:
                failed.append(lines[-1])
            if e_max >= worst:
                worst, worst_case = e_max, case
        log(f"swa_attention {dtype}: {len(B5_CASES)} shapes (B, S, Hq, Hkv, "
            f"D, W), worst max |kernel - plain| {worst:.3e} at {worst_case}"
            + (f" (bound {B5_FP32_ATOL:.0e})" if dtype == f32 else
               f"; worst {worst_ulp:.0f} bf16 ulp where |plain| >= 2^-8 "
               f"(bound 1), {n_small} elements below 2^-8 beyond 1 ulp, "
               f"all within 1 ulp + {B5_FP32_ATOL:.0e}"))
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "b5_cases.txt").write_text("\n".join(lines) + "\n")
    if failed:
        raise AssertionError("; ".join(failed))

    # the tensor-core design lives in what runs: the bf16 kernels' SASS
    # holds HGMMA (wgmma) instructions
    counts = sass_tensor_core_counts(build.library("swa_attention"))
    log("B5 SASS tensor-core instructions (cuobjdump -sass): " + "; ".join(
        f"{fn} {c['HGMMA']} HGMMA, {c['HMMA']} HMMA"
        for fn, c in sorted(counts.items())))
    main = counts.get(f"swa_fwd_wgmma<{B5_LAYER[4]}>", {})
    if not main.get("HGMMA", 0) + main.get("HMMA", 0):
        raise AssertionError(f"B5: no tensor-core instruction in the SASS of"
                             f" swa_fwd_wgmma<{B5_LAYER[4]}> ({counts})")

    # timing at gemma3-1b's "W" layer and hymba-1.5b's "Y" attention (seq
    # 2048, batch 1) in bf16, L2 flushed before every call (256 MB of
    # uint8, whose fill kernel no timed call launches)
    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    result["b5"] = _time_b5(gen, B5_LAYER, "gemma3-1b W layer", flush)
    hymba = _time_b5(gen, B5_HYMBA, "hymba-1.5b Y layer", flush)
    result["b5"]["hymba"] = hymba
    del flush
    torch.cuda.empty_cache()


def _time_b5(gen, shape, tag, flush) -> dict:
    """B5 at ``shape`` in bf16 beside its bound, its plain version and SDPA
    with the band mask, by card time (in turns) and per call; returns the
    kernels line's numbers."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.swa_attention import ops as swa_ops

    b, s, hq, hkv, d, w = shape
    q, k, v = _swa_inputs(gen, b, s, hq, hkv, d, torch.bfloat16)
    plain = _swa_plain(q, k, v, w)
    err = float((swa_ops.swa_attention_cuda(q, k, v, w).float()
                 - plain.float()).abs().max())

    def kernel():
        return swa_ops.swa_attention_cuda(q, k, v, w)

    def plain_fn():
        return _swa_plain(q, k, v, w)

    k_all, p_all = in_turns(kernel, plain_fn, turns=4, k_iters=20,
                            p_iters=5, flush=flush)
    pos = torch.arange(s, device="cuda")
    rel = pos[:, None] - pos[None, :]
    band = (rel >= 0) & (rel < w)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              enable_gqa=True)

    # the yardstick is SDPA pinned to cuDNN, the one fast backend that takes
    # grouped kv heads with a mask; the call as PyTorch dispatches it is
    # logged beside it
    default_all = [cuda_ms(sdpa, 20, flush=flush) for _ in range(2)]
    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        lib_err = float((sdpa().transpose(1, 2).float()
                         - plain.float()).abs().max())
        lib_all = [cuda_ms(sdpa, 20, flush=flush) for _ in range(4)]
        # card time, the yardstick: the card's work a call, without the
        # wrapper's host work that the per-call events also hold (the
        # plain version queues its kernels for ~1 ms: a longer spin); in
        # turns (B5, SDPA, plain, then the reverse)
        dev = {"kernel": [], "sdpa": [], "plain": []}
        sides = (("kernel", kernel, 20, 1_000_000),
                 ("sdpa", sdpa, 20, 1_000_000),
                 ("plain", plain_fn, 5, 10_000_000))
        for turn in range(4):
            for name, fn, iters, spin in (sides if turn % 2 == 0
                                          else sides[::-1]):
                dev[name].append(card_ms(fn, iters, flush, spin))
    log(f"SDPA at the {tag} with the band mask, enable_gqa, L2 flushed, per "
        f"call (CUDA events): pinned to CUDNN_ATTENTION {spread(lib_all)}; "
        f"unpinned dispatch {spread(default_all)}")
    # the band's (q, k) pairs in this input, 4*D flops each (q k^T and
    # p v); q, k, v read once and o written once
    pairs = sum(min(i + 1, w) for i in range(s))
    flops = b * hq * pairs * 4 * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    k_ms, p_ms, lib_ms = (statistics.median(dev[n])
                          for n in ("kernel", "plain", "sdpa"))
    log(f"swa_attention {tag} (B {b}, S {s}, {hq}q/{hkv}kv heads x {d}, W "
        f"{w}) bf16, L2 flushed. Card time a call: kernel "
        f"{spread(dev['kernel'])}, plain {spread(dev['plain'])}, SDPA with "
        f"the band mask (cuDNN) {spread(dev['sdpa'])}; B5 leads SDPA "
        f"{lib_ms / k_ms:.2f}x. Per call (CUDA events): kernel "
        f"{spread(k_all)}, plain {spread(p_all)}, SDPA (cuDNN) "
        f"{spread(lib_all)}. Bound {bound:.4f} ms by {bound_by} ({pairs} "
        f"pairs a head, {flops / 1e9:.2f} GFLOP = {t_ops * 1e3:.2f} us at "
        f"989 TFLOP/s; {nbytes / 1e6:.2f} MB = {t_bytes * 1e3:.2f} us at "
        f"3.35 TB/s); {flops / k_ms / 1e9:.1f} TFLOP/s by card time; max "
        f"|kernel - plain| {err:.3e}, |SDPA - plain| {lib_err:.3e}")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib_ms)


def _card_vs_cpu_round(arch: str, seq_len: int, **changes):
    """One SCAFFOLD round of ``arch``'s reduced fp32 config on the card
    (kernels) and on the CPU (plain versions) from the same weights, the
    spec changed by ``changes`` (an update space, a local solver; the
    LoRA init draws the same numpy normals on both sides); returns the
    max leaf rel err of x (the delta tree under a subset space), each
    side's launch counts and the round's local steps (S x K)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer, streams
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    cfg = get_reduced(arch)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.05,
                        strategy="client_sequential", **changes)
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    xs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        with streams.injected(_numpy_normals):
            tr = FederatedTrainer(
                partial(M.loss_fn, cfg),
                lambda gen: {k: v.clone() for k, v in p0.items()}, spec,
                SyntheticLMFederated(4, cfg.vocab_size, seq_len), seed=0,
                use_fused_update=True, device=dev)
        reset_launches()
        tr.run_round()
        counts[dev] = launches()
        xs[dev] = {k: v.cpu() for k, v in tr.x.items()}
    err = max(rel_err(xs["cuda"][k], xs["cpu"][k]) for k in xs["cpu"])
    return err, counts, spec.num_sampled * spec.local_steps


def phase_lm_small():
    """Phase 8: a 2-layer fp32 llama round, card vs CPU."""
    err, counts, steps = _card_vs_cpu_round("llama3.2-3b", 32)
    log(f"lm check: 2-layer fp32 llama, one SCAFFOLD round on the card (fused "
        f"kernel) vs the CPU (plain): max leaf rel err {err:.2e} (bound 1e-4);"
        f" card launches {counts['cuda']}")
    if not err <= 1e-4:
        raise AssertionError(f"lm check rel err {err}")
    if counts["cuda"]["scaffold_update"] != steps or any(
            counts["cpu"].values()):
        raise AssertionError(f"lm check launches {counts}")


def phase_gemma_small():
    """Phase 9: a 2-layer fp32 gemma3 ("WF", window 64) round at seq 128,
    card vs CPU: its "W" layer takes the band path, B5 on the card."""
    err, counts, steps = _card_vs_cpu_round("gemma3-1b", 128)
    log(f"gemma check: 2-layer fp32 gemma3 (WF, window 64), seq 128, one "
        f"SCAFFOLD round on the card (B5 + fused update) vs the CPU (plain):"
        f" max leaf rel err {err:.2e} (bound 1e-4); card launches "
        f"{counts['cuda']} (want swa_attention and scaffold_update {steps} "
        f"each: 1 W layer x S x K)")
    if not err <= 1e-4:
        raise AssertionError(f"gemma check rel err {err}")
    want = {k: 0 for k in counts["cuda"]}
    want.update(swa_attention=steps, scaffold_update=steps)
    if counts["cuda"] != want or any(counts["cpu"].values()):
        raise AssertionError(f"gemma check launches {counts}")


def _ssm_proj_width(cfg) -> int:
    """The Mamba2 in-projection's width, 2 d_inner + 2 N + H (0 without
    an SSM)."""
    if cfg.ssm is None:
        return 0
    sm, e = cfg.ssm, cfg.d_model
    return 2 * sm.d_inner(e) + 2 * sm.n_groups * sm.d_state + sm.n_heads(e)


def _ssm_chunk(cfg, seq_len: int) -> int:
    """The SSD's chunk length at ``seq_len`` (``layers._ssd_chunked``)."""
    chunk = min(cfg.ssm.chunk_size, seq_len)
    while seq_len % chunk:
        chunk //= 2
    return chunk


def _ssm_token_bytes(cfg, seq_len: int) -> int:
    """Activation bytes a Mamba2 block keeps for the backward pass, per
    token: the in-projection's output and the conv's input, products and
    output in bf16; the gate and the gated product in bf16; about 8 fp32
    tensors of width d_inner (x, the intra- and inter-chunk outputs, the
    skip, the gated norm's); and 3 fp32 intra-chunk tensors of (B, S/L,
    L, L, H) (the decay, its product with C B^T, the masked product that
    feeds the einsum), L the chunk."""
    if cfg.ssm is None:
        return 0
    sm, e = cfg.ssm, cfg.d_model
    di, h = sm.d_inner(e), sm.n_heads(e)
    conv_dim = di + 2 * sm.n_groups * sm.d_state
    return (2 * _ssm_proj_width(cfg) + 3 * 2 * conv_dim + 3 * 2 * di
            + 8 * 4 * di + 3 * 4 * _ssm_chunk(cfg, seq_len) * h)


def _meta_tree(cfg) -> dict:
    """cfg's parameter tree on the meta device (nothing allocated)."""
    import torch

    from repro_torch.models.model import param_tree

    return param_tree(cfg, None, torch.device("meta"))


def _tree_bytes(cfg) -> int:
    """Bytes of cfg's parameter tree, each leaf in its own dtype (hymba's
    and mamba2's fp32 SSD leaves in a bf16 model, whisper's fp32 tree),
    from the tree built on the meta device (nothing allocated)."""
    return sum(v.numel() * v.element_size()
               for v in _meta_tree(cfg).values())


def _moe_token_bytes(cfg, tokens: int) -> int:
    """Activation bytes an MoE layer keeps for the backward pass, per
    token of a forward over ``tokens`` tokens: the router's fp32 input,
    logits and probabilities and its int64 one-hot (k x n_experts); the
    shared experts' four products; under the ragged dispatch the k
    sorted copies of the token, the experts' four products of width f
    and the combine's un-sorted, weighted outputs; under gshard each
    token's share of its group's (g, n_experts, C) dispatch and combine
    tensors (fp32 and cast) and of the experts' inputs and products at
    their C slots. Compute dtype unless stated."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import _dtype

    mo = cfg.moe
    ab = _dtype(cfg.compute_dtype).itemsize
    e, f, n, k = cfg.d_model, mo.expert_d_ff, mo.num_experts, mo.top_k
    out = (4 * e + 2 * 4 * n + 8 * k * n
           + 4 * mo.shared_d_ff * mo.num_shared_experts * ab)
    if cfg.moe_impl == "gshard":
        g, cap = L._gshard_groups(cfg, tokens, mo.capacity_factor,
                                  mo.gshard_group_size)
        return out + n * cap * (8 + 2 * ab) + n * cap * (2 * e + 4 * f) * \
            ab // g
    return out + ((3 * k + 1) * e + 4 * k * f) * ab


def _lm_plan(cfg, seq_len: int, local_batch: int, slot_bytes: int = 0,
             subset=None, pending: int = 0, stack_grads: bool = True):
    """Reckoned peak device bytes of an LM phase at cfg's depth: the
    param-sized trees resident at once, each leaf in its dtype (x, c, the
    dy and dc sums, the client's c_i, c - c_i, its working copy y, and
    the grads or, after the steps, c_i_new and dc: 8), the client's
    solver slot (``slot_bytes`` a parameter), plus activations in the
    compute dtype (the S^2 probabilities of the dense "F" layers only,
    fp32 and in v's dtype, and one layer's fp32 score gradients: a "W"
    or "Y" layer keeps its q, k and v and recomputes its band in the
    backward pass, and an "F" layer past ``layers.FLASH_THRESHOLD``
    tokens keeps its fp32 q and one fp32 carry a kv block, recomputing
    each block's scores; an MLA layer also its q, expanded keys and
    values and two latents a token; an "M" or "Y" layer's Mamba2 block
    ``_ssm_token_bytes`` a token; an encoder's layers over its frames and the decoder's cross
    scores) and temporaries (the gradients of the vocab tables, both
    when the embeddings are untied; the CE's vocab chunks, or its full
    logits without chunks; the largest stacked leaf's gradient once).

    An MoE model's layers keep ``_moe_token_bytes`` a token in place of
    the MLP's (a dense layer's MLP at ``dense_d_ff`` once
    ``first_dense_layers`` is set), and its largest stacked leaf is read
    off the meta tree (the routed experts' (L, n_experts, d, f)).

    ``subset`` = (target params, delta-tree bytes[, the largest target's
    bytes]) plans an update space that trains a subset instead: the
    frozen base, the targets merged and their gradients (2 target-sized
    trees), the merge's and the projection's temporaries of the largest
    target (3), and the 8 trees above at the delta tree's size.
    ``stack_grads`` False plans targets
    that all sit above the layers (``unembed``, ``ln_final``): the
    layers then keep no activations for a backward pass.

    ``pending`` > 0 plans the async engine (``client_parallel``): its
    dy and dc sums are fp32 (2 trees more than bf16 sums), and each
    pending update keeps its dy and dc on the card (2 trees each; at most
    ``max_inflight + buffer_size - 1`` pending while an aggregation
    runs)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import _dtype, count_params_analytic

    n = count_params_analytic(cfg)
    tree = _tree_bytes(cfg)
    pb = _dtype(cfg.param_dtype).itemsize
    ab = _dtype(cfg.compute_dtype).itemsize
    t = seq_len * local_batch
    e, f, h = cfg.d_model, cfg.d_ff, cfg.num_heads
    pattern = cfg.pattern_for_layers()
    n_full = pattern.count("F")
    n_attn = sum(k != "M" for k in pattern)
    act = n_attn * t * (10 * e + 5 * f) * ab
    if cfg.moe is not None:
        mo = cfg.moe
        n_moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.num_layers))
        dense_f = mo.dense_d_ff if mo.first_dense_layers else f
        act = n_attn * t * 10 * e * ab + (n_attn - n_moe) * t * 5 * \
            dense_f * ab + n_moe * t * _moe_token_bytes(cfg, t)
    if cfg.mla is not None:
        # MLA's own per token: q (pre-split and whole), the expanded keys
        # (nope and whole), v, k_nope's up-projection, the two latents
        m = cfg.mla
        qk = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        act += n_attn * t * (4 * qk + 2 * h * m.v_head_dim + m.q_lora_rank
                             + m.kv_lora_rank) * ab
    if seq_len > L.FLASH_THRESHOLD:
        blocks = -(-seq_len // L.FLASH_BLOCK_KV)
        act += (n_full * (blocks + 1) * t * h * cfg.head_dim * 4
                + 4 * h * t * L.FLASH_BLOCK_KV * 4)
    elif n_full:
        # kept a layer: the fp32 softmax and the probabilities in v's
        # dtype; in one layer's backward at a time, two fp32 score grads
        act += (n_full * (4 + ab) + 2 * 4) * h * seq_len ** 2 * local_batch
    act += sum(k in "MY" for k in pattern) * t * _ssm_token_bytes(
        cfg, seq_len)
    if cfg.encoder is not None:
        frames = cfg.encoder.num_frames
        act += cfg.encoder.num_layers * local_batch * (
            frames * (10 * e + 5 * f) * ab + 2 * h * frames ** 2 * 4)
        act += n_full * 2 * h * t * frames * 4  # the cross scores
    if not stack_grads:
        act = 0
    largest = pb * cfg.num_layers * e * max(f, _ssm_proj_width(cfg))
    if cfg.moe is not None:
        largest = max(v.numel() * v.element_size()
                      for k, v in _meta_tree(cfg).items()
                      if k.startswith("layers/"))
    tables = 1 if cfg.tie_embeddings else 2
    temps = 2 * pb * tables * cfg.vocab_size * e + largest
    temps += (4 * t * cfg.loss_chunk_vocab * 4 if cfg.loss_chunk_vocab
              else 3 * t * cfg.vocab_size * 4)
    if subset is not None:
        n_t, delta_bytes = subset[:2]
        if len(subset) > 2:
            temps += subset[2] - largest
            largest = subset[2]
        trees = tree + 2 * pb * n_t + 3 * largest + 8 * delta_bytes
        if n_full and seq_len <= L.FLASH_THRESHOLD:
            # the entry point's evaluation after a round, when the
            # steps' activations are gone: one dense "F" layer's fp32
            # scores and softmax and its probabilities in v's dtype over
            # EVAL_ROWS rows at a time
            act = max(act, EVAL_ROWS * h * seq_len ** 2 * (8 + ab))
        if pending:
            trees += 2 * delta_bytes + pending * 2 * delta_bytes
        return n, tree, trees + act + temps
    if pending:
        temps += 2 * tree + pending * 2 * tree
    return n, tree, 8 * tree + slot_bytes * n + act + temps


def _plan_vs_peak(tag: str, plan: int, peak: int) -> None:
    """Log an LM phase's reckoned device bytes against its measured peak
    (``torch.cuda.max_memory_allocated``)."""
    log(f"{tag}: plan {plan / 1e9:.2f} GB against the peak "
        f"{peak / 1e9:.2f} GB ({(plan - peak) / 1e9:+.2f} GB over-reckoned)")


def _lm_fit(spec, seq_len: int, slot_bytes: int = 0,
            arch: str = "llama3.2-3b", chunk: int = 16032,
            max_layers: int = 0):
    """``arch`` at its published widths, CE over vocab chunks of
    ``chunk``, cut in depth (from its full depth, or ``max_layers``
    when set, down) until the device
    plan fits LM_MEMORY_LIMIT and the host rows (the store's N and the
    gathered cohort's S, each a c_i tree and a slot) fit
    HOST_MEMORY_LIMIT. Logs the reckoning; returns ``(cfg, n, tree
    bytes)``."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(arch), loss_chunk_vocab=chunk)
    rows = spec.num_clients + spec.num_sampled
    depth = min(base.num_layers, max_layers or base.num_layers)
    while True:
        cfg = dataclasses.replace(base, num_layers=depth)
        n, tree, peak = _lm_plan(cfg, seq_len, spec.local_batch, slot_bytes)
        host = rows * (tree + slot_bytes * n)
        if (peak <= LM_MEMORY_LIMIT and host <= HOST_MEMORY_LIMIT
                or depth == 1):
            break
        depth -= 1
    slot = (f" + the client's fp32 slot {slot_bytes * n / 1e9:.1f} GB"
            if slot_bytes else "")
    ssm = ""
    if cfg.ssm is not None:
        sm = cfg.ssm
        ssm = (f", Mamba2 d_inner {sm.d_inner(cfg.d_model)}, "
               f"{sm.n_heads(cfg.d_model)} heads x {sm.head_dim}, d_state "
               f"{sm.d_state}, chunk {_ssm_chunk(cfg, seq_len)}")
    log(f"lm: {cfg.name} widths (d_model {cfg.d_model}, {cfg.num_heads}q/"
        f"{cfg.num_kv_heads}kv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.mlp_kind}, vocab {cfg.vocab_size}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.param_dtype}, "
        f"pattern "
        f"{cfg.layer_pattern}{ssm}), CE over vocab chunks of "
        f"{cfg.loss_chunk_vocab}; {n} params, {tree / 1e9:.2f} GB a tree")
    log(f"lm: memory reckoning at num_layers {depth}, seq {seq_len}: 8 "
        f"param-sized trees = {8 * tree / 1e9:.1f} GB{slot} + activations "
        f"and temporaries = {peak / 1e9:.1f} GB (limit "
        f"{LM_MEMORY_LIMIT / 1e9:.0f} GB); host rows N {spec.num_clients} + "
        f"S {spec.num_sampled} = {rows} x {(tree + slot_bytes * n) / 1e9:.2f}"
        f" GB = {host / 1e9:.1f} GB (limit {HOST_MEMORY_LIMIT / 1e9:.0f} GB)")
    if depth != base.num_layers:
        log(f"reduced: num_layers {base.num_layers} -> {depth}")
    return cfg, n, tree


def _lm_trainer(cfg, spec, seq_len, **kw):
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    return FederatedTrainer(
        partial(M.loss_fn, cfg),
        lambda gen: M.init_params(cfg, gen, device="cuda"), spec,
        SyntheticLMFederated(spec.num_clients, cfg.vocab_size, seq_len),
        seed=0, use_fused_update=True, device="cuda", **kw)


# the profiler's own seconds after each profiled round, by tag
PROFILER_SECONDS = {}


def _device_time_ms(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    if us is None:
        us = getattr(ev, "self_cuda_time_total", 0.0)
    return us / 1e3


def _profile_round(tr, tag: str, kernels=(), want=None, tries=1,
                   cpu: bool = False):
    """One more round of trainer ``tr`` under the profiler: logs the wall
    time, the device busy share, the top device times by kernel and the
    device time of each kernel whose name holds one of ``kernels``; writes
    the table to ``OUT/<tag>_profile.txt``. The profiler records the CUDA
    activity alone (kernels, copies, memsets: all the busy share and the
    kernel times read) unless ``cpu``: the CPU ops' events were most of a
    round's and most of the profiler's own processing after it. ``want`` maps a name to the
    launches a round makes (or is a function of the launch counts the
    profiled round made, for a round whose launches vary): a profile that
    saw fewer lost events (on an H100 a quadratic round's profile lost its
    first B3 launch and its upload of A in one run of three), and another
    round is profiled, at most ``tries`` in all; the last is logged
    either way. Returns the busy share (None when the profiler reported
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu else [])
        with profile(activities=activities) as prof:
            # the profiler can miss a session's first device events: a
            # 1-element kernel goes first
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            before = launches()
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the profiler's own time after the round: its trace collected as
        # the block exits, then aggregated
        collect = time.perf_counter() - t0 - wall
        made = {k: v - before[k] for k, v in launches().items()}
        want_now = want(made) if callable(want) else want
        t1 = time.perf_counter()
        avgs = prof.key_averages()
        collect += time.perf_counter() - t1
        # device-side events only (kernels, copies): CPU ops also carry
        # the device time of the kernels they launched
        dev_events = [e for e in avgs if _device_time_ms(e) > 0
                      and "CUDA" in str(getattr(e, "device_type", ""))]
        seen = {k: sum(e.count for e in dev_events if k in e.key)
                for k in (want_now or {})}
        if all(seen[k] >= n for k, n in (want_now or {}).items()):
            break
        log(f"{tag} profiled round {attempt + 1} of {tries} lost events: "
            f"launches seen {seen}, made {want_now}")
    busy = sum(_device_time_ms(e) for e in dev_events) / 1e3
    top = sorted(dev_events, key=_device_time_ms, reverse=True)[:8]
    if busy > 0:
        log(f"{tag} profiled round (try {attempt + 1} of {tries}): wall "
            f"{wall:.3f} s, device busy "
            f"{busy:.4f} s ({100 * busy / wall:.1f}%); device time by "
            f"kernel: "
            + "; ".join(f"{e.key[:60]} {_device_time_ms(e):.3f} ms "
                        f"x{e.count}" for e in top))
        for name in kernels:
            mine = [e for e in dev_events if name in e.key]
            log(f"{tag} profiled round: {name} "
                f"{sum(_device_time_ms(e) for e in mine):.3f} ms device "
                f"time x{sum(e.count for e in mine)}")
    else:
        log(f"{tag} profiled round: wall {wall:.3f} s, device busy share not "
            f"measured (the profiler reported no device time)")
    sort_key = ("self_device_time_total" if hasattr(avgs[0],
                "self_device_time_total") else "self_cuda_time_total")
    OUT.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    (OUT / f"{tag}_profile.txt").write_text(avgs.table(sort_by=sort_key,
                                                       row_limit=40))
    own = collect + time.perf_counter() - t1
    PROFILER_SECONDS[tag] = own
    log(f"{tag} profiled round: the profiler's own processing "
        f"{own:.1f} s after the last try "
        f"({sum(e.count for e in avgs)} events, "
        f"{'CPU and CUDA' if cpu else 'CUDA'} activity)")
    return busy / wall if busy > 0 else None


def phase_lm_full(result):
    """Phase 11: the LM slice at llama3.2-3b widths in bf16."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import megakernel_incompatibility
    from repro_torch.kernels.scaffold_update import ops, ref

    seq_len, rounds = 256, 2
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy="client_sequential")
    cfg, n, tree = _lm_fit(spec, seq_len)
    depth = cfg.num_layers
    log(f"reduced: lm rounds 3 -> {rounds} (the script's time)")
    t0 = time.perf_counter()
    tr = _lm_trainer(cfg, spec, seq_len)
    torch.cuda.synchronize()
    log(f"lm: trainer set-up {time.perf_counter() - t0:.1f} s (init on the "
        f"card, host store of {tr.store.population_nbytes / 1e9:.1f} GB)")
    groups = len({(v.dtype,) * 3 for v in tr.x.values()})
    tokens = spec.num_sampled * spec.local_steps * spec.local_batch * seq_len

    reset_launches()
    secs, peaks = [], []
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        log(f"lm round {r + 1}: loss {m['loss']:.4f}, drift {m['drift']:.4e},"
            f" {secs[-1]:.3f} s, {tokens / secs[-1]:.1f} tokens/s, peak "
            f"device memory {peaks[-1] / 1e9:.2f} GB")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
            raise AssertionError(f"lm round {r + 1}: non-finite {m}")
    _plan_vs_peak("lm", _lm_plan(cfg, seq_len, spec.local_batch)[2],
                  max(peaks))
    counts = launches()
    want = rounds * spec.num_sampled * spec.local_steps * groups
    log(f"lm: scaffold_update launches {counts['scaffold_update']} == rounds"
        f" {rounds} x S {spec.num_sampled} x K {spec.local_steps} x groups "
        f"{groups} = {want}; all launches {counts}")
    if (counts["scaffold_update"] != want
            or sum(counts.values()) != want):
        raise AssertionError(f"lm: launches {counts}, want B1 {want} and "
                             f"nothing else")
    result.setdefault("b1_paths", {})["lm"] = counts["scaffold_update"]

    # B1 at this tree size: kernel vs plain vs bound
    gen = torch.Generator(device="cuda").manual_seed(3)
    y = {k: v.clone() for k, v in tr.x.items()}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda",
                        dtype=v.dtype) for k, v in tr.x.items()}
    corr = tr.c
    out = ops.scaffold_update_packed(y, g, corr, spec.eta_l)
    err = 0.0
    for k in y:
        plain = ref.scaffold_update_ref(y[k], g[k], corr[k], spec.eta_l)
        if ulp_distance(out[k], plain) > 1:
            raise AssertionError(f"lm tree B1 leaf {k} beyond 1 ulp")
        err = max(err, float((out[k].float() - plain.float()).abs().max()))
        del plain
    del out
    nbytes = sum(4 * v.numel() * v.element_size() for v in y.values())
    k_ms = cuda_ms(lambda: ops.scaffold_update_packed(
        y, g, corr, spec.eta_l, out=y), 10)
    p_ms = cuda_ms(lambda: [ref.scaffold_update_ref(y[k], g[k], corr[k],
                                                    spec.eta_l) for k in y], 3)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"scaffold_update llama3.2-3b@{depth}L tree ({n} bf16 params, "
        f"{len(y)} leaves, {groups} group): kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, bound {bound:.3f} ms (bytes, {nbytes / 1e9:.2f} GB),"
        f" {nbytes / k_ms / 1e6:.0f} GB/s; max |kernel - plain| {err:.3e}, "
        f"every leaf within 1 ulp")
    result["b1"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        bound_ms=bound)
    del y, g, corr

    # one more round under the profiler: device busy share, time by op
    _profile_round(tr, "lm")
    del tr
    torch.cuda.empty_cache()

    # the megakernel on this config falls back loudly, by the reference's
    # reason, and still trains through the per-step path
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = _lm_trainer(cfg, dataclasses.replace(spec, use_megakernel=True),
                         seq_len)
    m = tr.run_round()
    reason = tr.megakernel_fallback_reason
    log(f"lm use_megakernel=True: UserWarning {bool(caught)}, "
        f"megakernel_fallback_reason {m['megakernel_fallback_reason']!r}, "
        f"loss {m['loss']:.4f}")
    want_reason = megakernel_incompatibility(tr._grad_fn, tr.local_solver)
    if not caught or not reason or reason != want_reason:
        raise AssertionError(f"lm megakernel fallback: {reason!r}")
    del tr
    torch.cuda.empty_cache()


def phase_gemma_full(result):
    """Phase 10: gemma3-1b at its published widths and all 26 layers in
    bf16, seq 2048: every "W" layer's attention forward through B5, the
    local steps through B1; launch counts, round times, memory and a
    profiled round."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec

    seq_len, rounds = 2048, 2
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy="client_sequential")
    log(f"reduced: gemma rounds 3 -> {rounds} (the script's time)")
    cfg, _, _ = _lm_fit(spec, seq_len, arch="gemma3-1b",
                        chunk=get_config("gemma3-1b").vocab_size // 16)
    if cfg.num_layers != get_config("gemma3-1b").num_layers:
        raise AssertionError(f"gemma: the memory plan cut depth to "
                             f"{cfg.num_layers} layers")
    n_w = cfg.pattern_for_layers().count("W")
    t0 = time.perf_counter()
    tr = _lm_trainer(cfg, spec, seq_len)
    torch.cuda.synchronize()
    log(f"gemma: trainer set-up {time.perf_counter() - t0:.1f} s (init on the"
        f" card, host store of {tr.store.population_nbytes / 1e9:.1f} GB)")
    groups = len({v.dtype for v in tr.x.values()})
    steps = spec.num_sampled * spec.local_steps
    tokens = steps * spec.local_batch * seq_len

    reset_launches()
    peak = 0
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"gemma round {r + 1}: loss {m['loss']:.4f}, drift "
            f"{m['drift']:.4e}, {sec:.3f} s, {tokens / sec:.1f} tokens/s "
            f"({tokens} tokens), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, peak host "
            f"memory {host_peak_gb():.1f} GB")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
            raise AssertionError(f"gemma round {r + 1}: non-finite {m}")
    _plan_vs_peak("gemma", _lm_plan(cfg, seq_len, spec.local_batch)[2], peak)
    counts = launches()
    want = {k: 0 for k in counts}
    want.update(swa_attention=n_w * steps * rounds,
                scaffold_update=steps * groups * rounds)
    log(f"gemma: launches {counts}; want swa_attention = {n_w} W layers x "
        f"S {spec.num_sampled} x K {spec.local_steps} x rounds {rounds} = "
        f"{want['swa_attention']}, scaffold_update = S x K x groups {groups} "
        f"x rounds = {want['scaffold_update']}, nothing else")
    if counts != want:
        raise AssertionError(f"gemma: launches {counts} != {want}")
    result.setdefault("b5_paths", {})["gemma3-1b"] = counts["swa_attention"]
    result.setdefault("b1_paths", {})["gemma3-1b"] = counts["scaffold_update"]
    _profile_round(tr, "gemma", kernels=("swa_fwd_wgmma",
                                         "scaffold_update"))
    tr.close()
    del tr
    torch.cuda.empty_cache()


# the LM momentum trainer's depth: its rounds are host-bound on the slot
# and c_i rows (77 GB at the plan's 27 layers, ~25 s a round on an H100
# machine); cut to keep the script in its time limit as the serving
# phases came, and further as the MoE phases came
LM_MOMENTUM_LAYERS = 10


def phase_lm_momentum(result):
    """Phase 12: local heavy-ball on the LM through B2, the slot rows
    carried across rounds in the solver store, the trainer at
    ``LM_MOMENTUM_LAYERS``; B2 timed on the full-depth tree."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.kernels.scaffold_update import ops, ref

    # N = S = 2: both clients run every round, so round 2 starts from the
    # slot rows round 1 wrote
    seq_len, rounds = 256, 2
    spec = FedRoundSpec(algorithm="scaffold", num_clients=2, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        local_solver="momentum", local_momentum=0.9,
                        strategy="client_sequential")
    cfg, _, _ = _lm_fit(spec, seq_len, slot_bytes=4)
    if cfg.num_layers > LM_MOMENTUM_LAYERS:
        log(f"reduced: num_layers {cfg.num_layers} -> {LM_MOMENTUM_LAYERS} "
            f"(lm momentum, the script's time limit; B2 is timed on the "
            f"full-depth tree below)")
        cfg = dataclasses.replace(cfg, num_layers=LM_MOMENTUM_LAYERS)
    t0 = time.perf_counter()
    tr = _lm_trainer(cfg, spec, seq_len)
    torch.cuda.synchronize()
    log(f"lm momentum: trainer set-up {time.perf_counter() - t0:.1f} s (host"
        f" stores: c_i {tr.store.population_nbytes / 1e9:.1f} GB, solver "
        f"slots {tr.solver_store.population_nbytes / 1e9:.1f} GB)")
    groups = len({v.dtype for v in tr.x.values()})
    tokens = spec.num_sampled * spec.local_steps * spec.local_batch * seq_len

    reset_launches()
    peak = 0
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"lm momentum round {r + 1}: loss {m['loss']:.4f}, drift "
            f"{m['drift']:.4e}, {sec:.3f} s, {tokens / sec:.1f} tokens/s, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" GB, peak host memory {host_peak_gb():.1f} GB")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
            raise AssertionError(f"lm momentum round {r + 1}: non-finite {m}")
        if r == 0:
            # the slots round 1 wrote (a sample of each leaf of each row)
            rows = tr.solver_store.all_rows()
            seen = [max(float(v[i].reshape(-1)[:4096].abs().max())
                        for v in rows.values())
                    for i in range(spec.num_clients)]
            log(f"lm momentum: solver store after round 1, max |m| over the "
                f"first 4096 elements of each leaf, by client: "
                + ", ".join(f"{v:.4e}" for v in seen))
            if not all(v > 0 for v in seen):
                raise AssertionError("lm momentum: zero slot rows after "
                                     "round 1")
    _plan_vs_peak("lm momentum", _lm_plan(cfg, seq_len, spec.local_batch,
                                          slot_bytes=4)[2], peak)
    counts = launches()
    want = rounds * spec.num_sampled * spec.local_steps * groups
    log(f"lm momentum: scaffold_momentum_update launches "
        f"{counts['scaffold_momentum_update']} == rounds {rounds} x S "
        f"{spec.num_sampled} x K {spec.local_steps} x groups {groups} = "
        f"{want}; all launches {counts}")
    if (counts["scaffold_momentum_update"] != want
            or sum(counts.values()) != want):
        raise AssertionError(f"lm momentum: launches {counts}, want B2 "
                             f"{want} and nothing else")
    result.setdefault("b2_paths", {})["lm momentum"] = want
    tr.close()
    del tr
    torch.cuda.empty_cache()

    # B2 on the full-depth tree, whatever depth the trainer ran at: kernel
    # vs plain (in turns) vs bound
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    full = dataclasses.replace(cfg, num_layers=get_config(
        "llama3.2-3b").num_layers)
    gen = torch.Generator(device="cuda").manual_seed(7)
    eta, beta = spec.eta_l, spec.local_momentum
    y = M.init_params(full, gen, device="cuda")
    g, c = ({k: torch.randn(v.shape, generator=gen, device="cuda",
                            dtype=v.dtype) for k, v in y.items()}
            for _ in range(2))
    mm = {k: torch.randn(v.shape, generator=gen, device="cuda")
          for k, v in y.items()}
    out_y, out_m = ops.scaffold_momentum_update_packed(y, g, c, mm, eta, beta)
    err, worst = 0.0, (0, 0)
    for k in y:
        py, pm = ref.scaffold_momentum_update_ref(y[k], g[k], c[k], mm[k],
                                                  eta, beta)
        worst = (max(worst[0], ulp_distance(out_y[k], py)),
                 max(worst[1], ulp_distance(out_m[k], pm)))
        err = max(err, float((out_y[k].float() - py.float()).abs().max()),
                  float((out_m[k] - pm).abs().max()))
        del py, pm
    del out_y, out_m
    if worst[0] > 1 or worst[1] > 0:
        raise AssertionError(f"lm tree B2: {worst} ulp (y', m')")

    def plain():
        for k in y:
            ref.scaffold_momentum_update_ref(y[k], g[k], c[k], mm[k], eta,
                                             beta)

    k_all, p_all = in_turns(
        lambda: ops.scaffold_momentum_update_packed(
            y, g, c, mm, eta, beta, out=y, m_out=mm), plain,
        turns=4, k_iters=3, p_iters=1)
    # y, g, corr and m read once, y' and m' written once
    nbytes = sum(v.numel() * (3 * v.element_size() + 4 + v.element_size()
                              + 4) for v in y.values())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    k_ms, p_ms = statistics.median(k_all), statistics.median(p_all)
    n_full = sum(v.numel() for v in y.values())
    log(f"scaffold_momentum_update llama3.2-3b@{full.num_layers}L tree "
        f"({n_full} bf16 params, fp32 slot, {len(y)} leaves, "
        f"{len(ops.dtype_groups(y, g, c, mm))} group): kernel "
        f"{spread(k_all)}, plain {spread(p_all)}, bound {bound:.3f} ms "
        f"(bytes, {nbytes / 1e9:.2f} GB), {nbytes / k_ms / 1e6:.0f} GB/s; "
        f"max |kernel - plain| {err:.3e}, worst leaf {worst[0]} ulp in y', "
        f"{worst[1]} in m'")
    result["b2"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                        bound_ms=bound)
    del y, g, c, mm
    torch.cuda.empty_cache()


# the delta trees of this slice's spaces at the published widths
# (7 stacked LoRA targets x A/B at r 8; gemma3-1b's 9 layer groups x 7 x
# A/B; gemma3-1b's embed and ln_final)
LLAMA_LORA_ELEMENTS = 12_156_928
GEMMA_LORA_ELEMENTS = 6_522_880
LORA_RANK = 8
HEAD_TARGETS = "embed,ln_final*"


@contextlib.contextmanager
def _depth_cut(layers: int):
    """``repro_torch.launch.train`` (and ``serve``) build the preset
    config cut to ``layers`` layers within the block."""
    from repro_torch.launch import train

    preset = train.preset_config
    train.preset_config = lambda arch, p: dataclasses.replace(
        preset(arch, p), num_layers=layers)
    try:
        yield
    finally:
        train.preset_config = preset


def _lora_sizes(cfg, rank: int, targets: str = ""):
    """(params the LoRA targets hold, elements of the delta tree, the
    largest target's bytes) of cfg at ``targets`` (the defaults when
    empty), from the port's own target selection on the meta tree: a
    target (..., in, out) carries A (..., in, r) and B (..., r, out)."""
    from types import SimpleNamespace

    from repro_torch.core import update_space as U

    spec = SimpleNamespace(update_targets=targets, lora_rank=rank)
    hits = [v for _, v in U.get_update_space("lora").targets(
        spec, _meta_tree(cfg))]
    n_t = sum(v.numel() for v in hits)
    n_delta = sum(v.numel() // v.shape[-1] * rank
                  + v.numel() // v.shape[-2] * rank for v in hits)
    return n_t, n_delta, max(v.numel() * v.element_size() for v in hits)


def _space_sizes(cfg, space: str, rank: int = 0):
    """(params the space's targets hold, elements of its delta tree) at
    cfg: ``lora`` on the default targets (``_lora_sizes``); ``head_only``
    on ``embed`` and ``ln_final``."""
    if space == "lora":
        return _lora_sizes(cfg, rank)[:2]
    n = cfg.vocab_size * cfg.d_model + cfg.d_model
    return n, n


def _subset_plan(tag, cfg, seq_len, space, rank=0, stack_grads=True):
    """Log the device-memory plan of a subset-space phase at its full
    depth (these phases run through the entry point at the published
    config, so depth is not cut: a plan over the limit fails). Returns
    the delta tree's elements and the plan."""
    n_t, n_delta = _space_sizes(cfg, space, rank)
    delta_bytes = n_delta * (4 if space == "lora" else 2)
    n, tree, peak = _lm_plan(cfg, seq_len, 1, subset=(n_t, delta_bytes),
                             stack_grads=stack_grads)
    log(f"{tag}: {cfg.name} at its published widths, {cfg.num_layers} "
        f"layers, {n} bf16 params ({tree / 1e9:.2f} GB frozen); {space} "
        f"targets hold {n_t} params, the delta tree {n_delta} elements "
        f"({delta_bytes / 1e6:.1f} MB); memory reckoning {peak / 1e9:.1f} GB "
        f"(limit {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
    if peak > LM_MEMORY_LIMIT:
        raise AssertionError(f"{tag}: plan {peak / 1e9:.1f} GB over the "
                             f"limit")
    return n_delta, peak


def _train_argv(arch: str, seq_len: int, rounds: int, chunk: int, *extra):
    """``repro_torch.launch.train`` flags of this slice's phases: the
    published config, SCAFFOLD, N 4, S 2, K 2, batch 1, eta_l 0.01, an
    eval line after every round."""
    return ["--arch", arch, "--preset", "full", "--device", "cuda",
            "--loss-chunk-vocab", str(chunk), "--algorithm", "scaffold",
            "--clients", "4", "--sampled", "2", "--local-steps", "2",
            "--local-batch", "1", "--seq-len", str(seq_len), "--eta-l",
            "0.01", "--rounds", str(rounds), "--log-every", "1", *extra]


class _RoundLog:
    """Within the block every ``FederatedTrainer.run_round`` (those the
    entry point makes) is timed by the host clock, the card synchronised
    on both sides, and logged with its tokens/s, peak card and host
    memory and ``update_space``; ``rows`` keeps each round's metrics and
    seconds. With a ``plan`` (bytes) the block's end logs it against the
    rounds' peak."""

    def __init__(self, tag: str, tokens: int, plan: int = 0):
        self.tag, self.tokens, self.rows, self.plan = tag, tokens, [], plan

    def __enter__(self):
        import torch

        from repro_torch.core import controller

        cls = controller.FederatedTrainer
        self._cls, self._inner = cls, cls.run_round
        inner, rows, tag, tokens = self._inner, self.rows, self.tag, \
            self.tokens

        def timed(trainer):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = inner(trainer)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rows.append(dict(m, seconds=sec,
                             peak_bytes=torch.cuda.max_memory_allocated()))
            log(f"{tag} round {m['round']}: loss {m['loss']:.4f}, drift "
                f"{m['drift']:.4e}, {sec:.3f} s, {tokens / sec:.1f} tokens/s"
                f" ({tokens} tokens), peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, peak host"
                f" memory {host_peak_gb():.1f} GB, update_space "
                f"{m.get('update_space')!r}, bytes_up {m['bytes_up']:.0f}, "
                f"bytes_down {m['bytes_down']:.0f}")
            if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
                raise AssertionError(f"{tag}: non-finite round {m}")
            return m

        cls.run_round = timed
        return self

    def __exit__(self, *exc):
        self._cls.run_round = self._inner
        if self.plan and self.rows and exc[0] is None:
            _plan_vs_peak(self.tag, self.plan,
                          max(r["peak_bytes"] for r in self.rows))
        return False


def _check_subset_rounds(tag, tr, rows, space, elements, elem_bytes):
    """Every round's metrics carry ``update_space == space`` and bytes
    equal to ``round_comm_bytes`` over the delta tree, which holds
    ``elements`` elements of ``elem_bytes`` bytes: up, dy and dc of S
    clients; down, x and c to each."""
    from repro_torch.core import round_comm_bytes

    spec = tr.spec
    got = sum(v.numel() for v in tr.x.values())
    want = round_comm_bytes(spec, tr.x, stateful_clients=True)
    formula = 2 * spec.num_sampled * elements * elem_bytes
    log(f"{tag}: delta tree {len(tr.x)} leaves, {got} elements (want "
        f"{elements}); bytes_up {rows[-1]['bytes_up']:.0f} == "
        f"round_comm_bytes {want['bytes_up']} == 2 x S {spec.num_sampled} x "
        f"{elements} x {elem_bytes} B = {formula}")
    if got != elements or want["bytes_up"] != formula or any(
            r["update_space"] != space or r["bytes_up"] != formula
            or r["bytes_down"] != want["bytes_down"] for r in rows):
        raise AssertionError(f"{tag}: rows {rows}, want {want}")


def _time_update_tree(tag, x, c, eta, beta=None):
    """B1 (B2 with ``beta``, a random fp32 slot) on tree ``x`` with the
    correction ``c``: against the plain version (B1 within 1 ulp; B2 1
    ulp in y' and 0 in m', as phases 3-4), then kernel and plain version
    timed in turns by card time a call (``card_ms``, L2 flushed: the
    spin hides the wrapper's host time, which at 126 leaves exceeds the
    kernel's), beside the bound by bytes (y, g and corr, and m, read
    once, y' and m' written once); the kernel's time a call by CUDA
    events without the spin, and the wrapper's host time a call, beside
    them."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    y = {k: v.clone() for k, v in x.items()}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda",
                        dtype=v.dtype) for k, v in x.items()}
    corr = {k: c[k].clone() for k in x}
    m = None if beta is None else {
        k: torch.randn(v.shape, generator=gen, device="cuda")
        for k, v in x.items()}
    err, worst = 0.0, (0, 0)
    if m is None:
        out = ops.scaffold_update_packed(y, g, corr, eta)
        for k in y:
            plain = ref.scaffold_update_ref(y[k], g[k], corr[k], eta)
            worst = (max(worst[0], ulp_distance(out[k], plain)), 0)
            err = max(err, float((out[k].float() - plain.float()).abs().max()))
        del out, plain  # the timed calls write into y
        ok = worst[0] <= 1

        def kernel():
            ops.scaffold_update_packed(y, g, corr, eta, out=y)

        def plain_fn():
            for k in y:
                ref.scaffold_update_ref(y[k], g[k], corr[k], eta)
    else:
        out_y, out_m = ops.scaffold_momentum_update_packed(y, g, corr, m, eta,
                                                           beta)
        for k in y:
            py, pm = ref.scaffold_momentum_update_ref(y[k], g[k], corr[k],
                                                      m[k], eta, beta)
            worst = (max(worst[0], ulp_distance(out_y[k], py)),
                     max(worst[1], ulp_distance(out_m[k], pm)))
            err = max(err, float((out_y[k].float() - py.float()).abs().max()),
                      float((out_m[k] - pm).abs().max()))
        ok = worst[0] <= 1 and worst[1] == 0

        def kernel():
            ops.scaffold_momentum_update_packed(y, g, corr, m, eta, beta,
                                                out=y, m_out=m)

        def plain_fn():
            for k in y:
                ref.scaffold_momentum_update_ref(y[k], g[k], corr[k], m[k],
                                                 eta, beta)
    if not ok:
        raise AssertionError(f"{tag}: {worst} ulp from plain")
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    # spin cycles before a timed call: ~2 ms at the H100's clocks for the
    # kernel (its wrapper takes ~0.5 ms of host time at 126 leaves), ~10
    # ms for the plain version's few launches a leaf
    k_all, p_all = [], []
    for turn in range(4):
        for side in (("plain", "kernel") if turn % 2 == 0
                     else ("kernel", "plain")):
            if side == "kernel":
                k_all.append(card_ms(kernel, 10, flush, 4_000_000))
            else:
                p_all.append(card_ms(plain_fn, 3, flush, 20_000_000))
    per_call = cuda_ms(kernel, 10, flush=flush)
    host = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    host_us = 1e6 * statistics.median(host)
    n = sum(v.numel() for v in y.values())
    nbytes = sum(v.numel() * (3 * v.element_size() + corr[k].element_size()
                              + (0 if m is None else 8))
                 for k, v in y.items())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    groups = len(ops.dtype_groups(y, g, corr, m))
    k_ms, p_ms = statistics.median(k_all), statistics.median(p_all)
    log(f"{tag} ({n} elements, {len(y)} leaves, {groups} dtype group"
        f"{'s' if groups > 1 else ''}, y {next(iter(y.values())).dtype}): "
        f"card time a call, kernel {spread(k_all)}, plain {spread(p_all)}; "
        f"bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB, L2 flushed), "
        f"{nbytes / k_ms / 1e6:.0f} GB/s, {100 * bound / k_ms:.1f} % of the "
        f"bound; kernel per call with no spin (CUDA events) {per_call:.4f} "
        f"ms, wrapper host time {host_us:.1f} us a call; max |kernel - "
        f"plain| {err:.3e}, worst leaf {worst[0]} ulp in y'"
        + ("" if m is None else f", {worst[1]} in m'"))
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, max_abs_err=err,
                per_call_ms=per_call, host_us=host_us, elements=n,
                leaves=len(y), groups=groups)


def phase_lora_llama(result):
    """Phase 18: LoRA on llama3.2-3b at its published widths and all 28
    layers in bf16, through ``repro_torch.launch.train.main``: rank 8 on
    the default targets, SCAFFOLD, N 4, S 2, K 2, batch 1, seq 256, 3
    rounds and a profiled fourth; B1 on the one fp32 group of 14 leaves
    S x K times a round, the bytes of the delta tree; B1 and B2 timed on
    the tree."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    seq_len, rounds, chunk = 256, 3, 16032
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              loss_chunk_vocab=chunk)
    elements, plan = _subset_plan("lora llama", cfg, seq_len,
                                  "lora", LORA_RANK)
    steps, tokens = 2 * 2, 2 * 2 * seq_len
    reset_launches()
    t0 = time.perf_counter()
    with _RoundLog("lora llama", tokens, plan) as rl:
        tr = train.main(_train_argv(
            "llama3.2-3b", seq_len, rounds, chunk, "--update-space", "lora",
            "--lora-rank", str(LORA_RANK)))
    counts = launches()
    secs = [r["seconds"] for r in rl.rows]
    log(f"lora llama: train.main {time.perf_counter() - t0:.1f} s in all; "
        f"s/round {', '.join(f'{s:.3f}' for s in secs)}, rounds 2-{rounds} "
        f"mean {statistics.mean(secs[1:]):.3f} s, "
        f"{tokens / statistics.mean(secs[1:]):.1f} tokens/s")
    if elements != LLAMA_LORA_ELEMENTS or len(tr.x) != 14 or any(
            v.dtype != torch.float32 for v in tr.x.values()):
        raise AssertionError(f"lora llama: delta tree {elements}, "
                             f"{ {k: v.dtype for k, v in tr.x.items()} }")
    _check_subset_rounds("lora llama", tr, rl.rows, "lora", elements, 4)
    want = rounds * steps
    log(f"lora llama: launches {counts}; want scaffold_update = rounds "
        f"{rounds} x S x K {steps} x 1 group = {want}, nothing else")
    if counts["scaffold_update"] != want or sum(counts.values()) != want:
        raise AssertionError(f"lora llama: launches {counts}")
    result.setdefault("b1_paths", {})["lora llama3.2-3b"] = want
    result["b1"].setdefault("trees", {})["llama lora"] = _time_update_tree(
        "scaffold_update at the llama3.2-3b LoRA tree", tr.x, tr.c, 0.01)
    result["b2"].setdefault("trees", {})["llama lora"] = _time_update_tree(
        "scaffold_momentum_update at the llama3.2-3b LoRA tree", tr.x, tr.c,
        0.01, beta=0.9)
    _profile_round(tr, "lora_llama", kernels=("scaffold_update",),
                   want={"scaffold_update": steps}, tries=2)
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_lora_gemma(result):
    """Phase 19: LoRA on gemma3-1b at its published widths, 26 layers,
    seq 2048, through the entry point: 3 unbroken rounds; 2 rounds and
    ``--checkpoint``, then a fresh ``--resume`` runs round 3 and must equal
    the unbroken run bitwise; the checkpoint serves through
    ``load_serving_params``, equal to the saving trainer's
    ``eval_params()``; B5 on every "W" layer, B1 on the fp32 group of 126
    leaves. The checkpoint stays for phase 43 to serve."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import load_serving_params
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.launch import train
    from repro_torch.models import model as M

    base = get_config("gemma3-1b")
    seq_len, chunk = 2048, base.vocab_size // 16
    cfg = dataclasses.replace(base, loss_chunk_vocab=chunk)
    elements, plan = _subset_plan("lora gemma", cfg, seq_len,
                                  "lora", LORA_RANK)
    n_w, steps = cfg.pattern_for_layers().count("W"), 2 * 2
    tokens = steps * seq_len
    lora = ("--update-space", "lora", "--lora-rank", str(LORA_RANK))
    ckpt = OUT / "lora_gemma_ckpt"

    def run(tag, rounds, *extra):
        reset_launches()
        t0 = time.perf_counter()
        with _RoundLog(f"lora gemma, {tag}", tokens, plan) as rl:
            tr = train.main(_train_argv("gemma3-1b", seq_len, rounds, chunk,
                                        *lora, *extra))
        counts = launches()
        # training: B5 on every W layer of every step, B1 on every step;
        # the entry point's eval after each round: B5 once a W layer
        want = {k: 0 for k in counts}
        want.update(swa_attention=rounds * n_w * (steps + 1),
                    scaffold_update=rounds * steps)
        log(f"lora gemma, {tag}: train.main {time.perf_counter() - t0:.1f} s"
            f" in all; launches {counts}; want swa_attention = rounds "
            f"{rounds} x {n_w} W layers x (S x K {steps} + 1 eval) = "
            f"{want['swa_attention']}, scaffold_update = rounds x S x K = "
            f"{want['scaffold_update']}, nothing else")
        if counts != want:
            raise AssertionError(f"lora gemma {tag}: launches {counts}")
        paths = result.setdefault("b1_paths", {})
        paths["lora gemma3-1b"] = (paths.get("lora gemma3-1b", 0)
                                   + counts["scaffold_update"])
        paths = result.setdefault("b5_paths", {})
        paths["lora gemma3-1b"] = (paths.get("lora gemma3-1b", 0)
                                   + counts["swa_attention"])
        return tr, rl.rows

    tr, rows = run("3 rounds unbroken", 3)
    _check_subset_rounds("lora gemma", tr, rows, "lora", elements, 4)
    if elements != GEMMA_LORA_ELEMENTS or len(tr.x) != 126:
        raise AssertionError(f"lora gemma: delta tree {elements}, "
                             f"{len(tr.x)} leaves")
    unbroken = {k: v.clone() for k, v in {**tr.x, **{
        f"c/{k}": v for k, v in tr.c.items()}}.items()}
    result["b1"].setdefault("trees", {})["gemma lora"] = _time_update_tree(
        "scaffold_update at the gemma3-1b LoRA tree", tr.x, tr.c, 0.01)
    tr.close()
    del tr
    torch.cuda.empty_cache()

    tr, _ = run("rounds 1-2 and --checkpoint", 2, "--checkpoint", str(ckpt))
    path = str(ckpt) + ".npz"
    size = Path(path).stat().st_size
    t0 = time.perf_counter()
    served = load_serving_params(path)
    t_load = time.perf_counter() - t0
    mine = tr.eval_params()
    apart = [k for k in mine if not torch.equal(served[k], mine[k])]
    data = SyntheticLMFederated(4, cfg.vocab_size, seq_len)
    batch = data.eval_batch(8, np.random.default_rng(7), device="cuda")
    with torch.no_grad():
        loss = float(M.loss_fn(cfg, served, batch)[0])
    log(f"lora gemma: checkpoint {size / 1e9:.2f} GB; load_serving_params "
        f"{t_load:.1f} s, {len(served)} leaves, {len(apart)} apart from the "
        f"saving trainer's eval_params() (want 0); eval loss of the served "
        f"params {loss:.4f} (8 x {seq_len} tokens)")
    if apart or sorted(served) != sorted(mine) or not math.isfinite(loss):
        raise AssertionError(f"lora gemma: served params apart at {apart}")
    tr.close()
    del tr, served, mine
    torch.cuda.empty_cache()

    tr, _ = run("--resume and round 3", 1, "--resume", path)
    resumed = {**tr.x, **{f"c/{k}": v for k, v in tr.c.items()}}
    diff = max(float((resumed[k] - v).abs().max()) for k, v in
               unbroken.items())
    apart = [k for k, v in unbroken.items() if not torch.equal(resumed[k], v)]
    log(f"lora gemma: resumed round 3 against the unbroken run: "
        f"{len(apart)} of {len(unbroken)} x and c leaves apart (want 0, "
        f"bitwise), max |diff| {diff:.3e}; round counter {tr.round_idx}")
    if apart or tr.round_idx != 3:
        raise AssertionError(f"lora gemma: resume apart at {apart[:5]}")
    tr.close()
    del tr, unbroken, resumed
    result["lora_gemma_ckpt"] = path  # served by phase 43, deleted there
    torch.cuda.empty_cache()


def phase_head_only_gemma(result):
    """Phase 20: head_only on gemma3-1b (``embed`` and ``ln_final``, bf16)
    at its published widths, 26 layers, seq 2048, 2 rounds through the
    entry point: B1 on the bf16 group of 2 leaves, the bytes of the
    delta tree; B1 timed on it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    base = get_config("gemma3-1b")
    seq_len, rounds, chunk = 2048, 2, base.vocab_size // 16
    cfg = dataclasses.replace(base, loss_chunk_vocab=chunk)
    elements, plan = _subset_plan("head_only gemma", cfg, seq_len, "head_only")
    n_w, steps = cfg.pattern_for_layers().count("W"), 2 * 2
    reset_launches()
    t0 = time.perf_counter()
    with _RoundLog("head_only gemma", steps * seq_len, plan) as rl:
        tr = train.main(_train_argv("gemma3-1b", seq_len, rounds, chunk,
                                    "--update-space", "head_only",
                                    "--lora-targets", HEAD_TARGETS))
    counts = launches()
    if sorted(tr.x) != ["embed", "ln_final.scale"] or any(
            v.dtype != torch.bfloat16 for v in tr.x.values()):
        raise AssertionError(f"head_only gemma: delta tree "
                             f"{ {k: v.dtype for k, v in tr.x.items()} }")
    _check_subset_rounds("head_only gemma", tr, rl.rows, "head_only",
                         elements, 2)
    want = {k: 0 for k in counts}
    want.update(swa_attention=rounds * n_w * (steps + 1),
                scaffold_update=rounds * steps)
    log(f"head_only gemma: train.main {time.perf_counter() - t0:.1f} s in "
        f"all; launches {counts}; want {want}")
    if counts != want:
        raise AssertionError(f"head_only gemma: launches {counts}")
    result.setdefault("b1_paths", {})["head_only gemma3-1b"] = want[
        "scaffold_update"]
    result.setdefault("b5_paths", {})["head_only gemma3-1b"] = want[
        "swa_attention"]
    result["b1"].setdefault("trees", {})["gemma head_only"] = (
        _time_update_tree("scaffold_update at the gemma3-1b head_only tree",
                          tr.x, tr.c, 0.01))
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_spaces_small(result):
    """Phase 21: the update spaces card against CPU at reduced depth: one
    SCAFFOLD round of the 2-layer fp32 llama in ``lora``, ``head_only``
    and ``lora`` with local heavy-ball (B2 on the delta tree), the same
    weights and LoRA init on both sides."""
    for name, changes, kernel in (
            ("lora", dict(update_space="lora", lora_rank=4),
             "scaffold_update"),
            ("head_only", dict(update_space="head_only",
                               update_targets=HEAD_TARGETS),
             "scaffold_update"),
            ("lora heavy-ball", dict(update_space="lora", lora_rank=4,
                                     local_solver="momentum"),
             "scaffold_momentum_update")):
        err, counts, steps = _card_vs_cpu_round("llama3.2-3b", 32, **changes)
        log(f"spaces check: 2-layer fp32 llama, {name}, one SCAFFOLD round "
            f"on the card (kernels) vs the CPU (plain): max delta-leaf rel "
            f"err {err:.2e} (bound 1e-4); card launches {counts['cuda']} "
            f"(want {kernel} {steps}, nothing else)")
        if not err <= 1e-4:
            raise AssertionError(f"spaces check {name}: rel err {err}")
        if (counts["cuda"][kernel] != steps
                or sum(counts["cuda"].values()) != steps
                or any(counts["cpu"].values())):
            raise AssertionError(f"spaces check {name}: launches {counts}")
        key = "b1_paths" if kernel == "scaffold_update" else "b2_paths"
        result.setdefault(key, {})[f"{name} card vs CPU"] = steps


def _quad_paths(ds, spec, runs, b_keys, rounds=3, profile=None):
    """Train ``spec`` on ``ds`` once per ``(name, changes, launches)`` run
    on the card, the launch counts set to 0 just before each run and read
    just after; each round is timed alone (the suboptimality is evaluated
    on the host after it). Raises unless the counts of ``b_keys`` equal
    ``launches`` and every other count is 0, or if a K-step loop launched
    on one block. The run named ``profile`` then trains one more round
    under the profiler. Returns ``{name: final x}`` and ``{name: counts
    of b_keys}``."""
    import torch

    from repro_torch.core import FederatedTrainer
    from repro_torch.data import quadratic_loss
    from repro_torch.kernels.scaffold_update import megakernel as mk

    xs, counts = {}, {}
    for name, changes, want in runs:
        sp = dataclasses.replace(spec, **changes)
        tr = FederatedTrainer(quadratic_loss,
                              lambda gen: {"x": torch.ones(ds.dim)}, sp, ds,
                              seed=0, use_fused_update=True, device="cuda")
        subs = [ds.suboptimality(tr.x)]
        reset_launches()
        secs = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            subs.append(ds.suboptimality(tr.x))
            if sp.use_megakernel and m["megakernel_fallback_reason"] != "":
                raise AssertionError(f"quad {name} fell back: {m}")
        counts_now = launches()
        got = tuple(counts_now[k] for k in b_keys)
        log(f"quad {name}: launches ({', '.join(b_keys)}) = {got}; "
            f"suboptimality " + " -> ".join(f"{s:.4e}" for s in subs)
            + "; s/round " + ", ".join(f"{s:.4f}" for s in secs)
            + f" (rounds 2-{rounds} mean {statistics.mean(secs[1:]):.4f})")
        others = sum(v for k, v in counts_now.items() if k not in b_keys)
        if got != want or others:
            raise AssertionError(f"quad {name}: launches {counts_now}, "
                                 f"want {dict(zip(b_keys, want))}")
        for k, n in zip(b_keys, got):
            if n and k in mk.PLANS:
                log(f"quad {name}: {k} plans: {_plans(k)}")
        if not all(math.isfinite(v) for v in subs):
            raise AssertionError(f"quad {name}: suboptimality {subs}")
        xs[name], counts[name] = tr.x["x"].cpu(), got
        if name == profile:
            _profile_round(tr, "quad_" + re.sub(r"\W+", "_", name),
                           kernels=("grid_loop_kernel",),
                           want={"grid_loop_kernel": sp.num_sampled},
                           tries=3)
    return xs, counts


def _time_local_loop(ds, beta=None):
    """B3 (or B4 with ``beta``) at d=1024, K=10, bsz=1, fp32, in two
    layouts of A: "fresh", a distinct A per step (the kernels line's
    ``bound_ms``: K*d*d*4 bytes), and "broadcast", the trainer's own
    stride-0 view of one client's A (quadratics.round_batches), whose
    bound counts its 4 MB once. The card's time a call (``card_ms``, L2
    flushed) of the kernel, of K grid barriers alone on its grid
    (``megakernel.barrier_floor``: the design's floor) and of the plain
    version, in alternating turns; the kernel's per-call CUDA-event time
    without the spin beside them (``tools/local_loop_probe.py`` splits
    the time further). Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, K = 1024, 10
    y, corr, eta, A, b = _b3_inputs(gen, d, K, 1, torch.float32,
                                    torch.float32)
    kw = {} if beta is None else dict(
        m=torch.randn(d, generator=gen, device="cuda"), beta=beta)
    view = ds.round_batches(np.array([0]), K, 1, None, device="cuda")
    layouts = {"fresh": (A, b, K * d * d * 4 + K * d * 4),
               "broadcast": (view["A"][0], view["b"][0], d * d * 4 + d * 4)}
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = "scaffold_local_loop" if beta is None else (
        "scaffold_momentum_local_loop")
    # spin cycles before a timed call: ~0.5 ms at the H100's clocks, far
    # above the kernel wrapper's host time; the plain version queues ~100
    # kernels, ~2 ms of host work, so it waits ~5 ms
    spin = {"plain": 10_000_000}
    out = {}
    for layout, (A, b, a_bytes) in layouts.items():
        plan = mk.local_loop_plan(d, K, A.stride(0), sms)
        fns = {
            "kernel": lambda: mk.scaffold_local_loop_cuda(y, corr, eta, A, b,
                                                          **kw),
            "plain": lambda: ref.scaffold_local_loop_ref(y, corr, eta, A, b,
                                                         **kw),
            "K barriers": lambda: mk.barrier_floor(plan, K, "cuda")}
        err = float((fns["kernel"]()[0] - fns["plain"]()[0]).abs().max())
        dev = {k: [] for k in fns}
        for turn in range(4):
            for k in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
                dev[k].append(card_ms(fns[k], 3 if k == "plain" else 10,
                                      flush, spin.get(k, 1_000_000)))
        per_call = cuda_ms(fns["kernel"], 20, flush=flush)
        # bytes: A and b read once, y and corr (and m) read, y_K (and m_K)
        # and the losses written
        nbytes = a_bytes + (4 if beta is None else 6) * d * 4 + K * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        med = {k: statistics.median(v) for k, v in dev.items()}
        log(f"{name} d={d} K={K} bsz=1 fp32, A {layout}, {plan.grid} blocks"
            f" x {plan.rows} rows, "
            f"{'resident' if plan.resident else 'streaming'}: card time a "
            f"call, kernel {spread(dev['kernel'])}, plain "
            f"{spread(dev['plain'])}, {K} grid barriers alone "
            f"{spread(dev['K barriers'])}; kernel per call with no spin "
            f"(CUDA events) {per_call:.4f} ms; bound {bound:.4f} ms (bytes, "
            f"{nbytes / 1e6:.2f} MB, L2 flushed); max |y_K kernel - plain| "
            f"{err:.3e}")
        out[layout] = dict(err=err, bound=bound, **med)
    fresh, bcast = out["fresh"], out["broadcast"]
    return dict(max_abs_err=max(fresh["err"], bcast["err"]),
                ms=fresh["kernel"], plain_ms=fresh["plain"],
                bound_ms=fresh["bound"], broadcast_ms=bcast["kernel"],
                broadcast_bound_ms=bcast["bound"],
                barrier_floor_ms=bcast["K barriers"])


def phase_quadratics(ds, result):
    """Phase 13: the quadratics slice, K-step kernel vs per-step path."""
    from repro_torch.configs.base import FedRoundSpec

    spec = FedRoundSpec(algorithm="scaffold", num_clients=20, num_sampled=4,
                        local_steps=10, local_batch=1, eta_l=0.1)
    xs, counts = _quad_paths(ds, spec, (
        ("megakernel", dict(use_megakernel=True), (12, 0)),
        ("per_step_fused", {}, (0, 120))),
        ("scaffold_local_loop", "scaffold_update"), profile="megakernel")
    err = rel_err(xs["megakernel"], xs["per_step_fused"])
    log(f"quad: final x, megakernel vs per-step fused path: rel err "
        f"{err:.2e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"quad final x rel err {err}")
    result.setdefault("b3_paths", {})["quadratics"] = counts["megakernel"][0]
    result.setdefault("b1_paths", {})["quadratics per-step"] = counts[
        "per_step_fused"][1]
    result["b3"] = _time_local_loop(ds)


def phase_quad_heavy_ball(ds, result):
    """Phase 14: scaffold_m with local heavy-ball, the B4 path vs the
    per-step B2 path."""
    from repro_torch.configs.base import FedRoundSpec

    # server momentum 0.9 (scaffold_m's default) at eta_g 0.1, local
    # momentum 0.9 at eta_l 0.1
    spec = FedRoundSpec(algorithm="scaffold_m", num_clients=20, num_sampled=4,
                        local_steps=10, local_batch=1, eta_l=0.1, eta_g=0.1,
                        local_solver="momentum", local_momentum=0.9)
    xs, counts = _quad_paths(ds, spec, (
        ("heavy-ball megakernel", dict(use_megakernel=True), (12, 0)),
        ("heavy-ball per_step_fused", {}, (0, 120))),
        ("scaffold_momentum_local_loop", "scaffold_momentum_update"))
    err = rel_err(xs["heavy-ball megakernel"], xs["heavy-ball per_step_fused"])
    log(f"quad heavy-ball: final x, B4 path vs per-step B2 path: rel err "
        f"{err:.2e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"quad heavy-ball final x rel err {err}")
    result.setdefault("b4_paths", {})["quadratics heavy-ball"] = counts[
        "heavy-ball megakernel"][0]
    result.setdefault("b2_paths", {})["quadratics per-step"] = counts[
        "heavy-ball per_step_fused"][1]
    result["b4"] = _time_local_loop(ds, beta=spec.local_momentum)


def phase_quad_sched_adam(ds, result):
    """Phase 15: sgd_sched's cosine table through B3 with server adam;
    local adam, fedprox and the head_only update space ask for the K-step
    kernel and fall back to the per-step path, by the reference's
    reasons: no B3 or B4 launch (head_only's steps through B1)."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import quadratic_loss

    spec = FedRoundSpec(algorithm="scaffold", num_clients=20, num_sampled=4,
                        local_steps=10, local_batch=1, eta_l=0.1,
                        use_megakernel=True)
    _, counts = _quad_paths(ds, spec, (
        ("sgd_sched cosine, server adam", dict(
            local_solver="sgd_sched", eta_l_schedule="cosine",
            server_optimizer="adam", eta_g=0.1), (12,)),),
        ("scaffold_local_loop",))
    result.setdefault("b3_paths", {})["quadratics sgd_sched"] = counts[
        "sgd_sched cosine, server adam"][0]
    grad_reason = ("grad not kernel-expressible (loss_fn lacks "
                   "megakernel_grad='quadratic')")
    for name, changes, want, per_step in (
            ("local adam", dict(local_solver="adam", eta_l=0.03),
             "local solver 'adam' has no megakernel variant", 0),
            ("fedprox", dict(algorithm="fedprox"),
             "FedProx prox term is not expressible in the megakernel", 0),
            # a space that trains a subset differentiates in delta space,
            # which the K-step kernel cannot: the per-step path, B1
            ("head_only space", dict(update_space="head_only",
                                     update_targets="x"), grad_reason,
             3 * spec.num_sampled * spec.local_steps)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = FederatedTrainer(quadratic_loss,
                                  lambda gen: {"x": torch.ones(ds.dim)},
                                  dataclasses.replace(spec, **changes), ds,
                                  seed=0, use_fused_update=True,
                                  device="cuda")
        subs = [ds.suboptimality(tr.x)]
        reset_launches()
        for _ in range(3):
            m = tr.run_round()
            subs.append(ds.suboptimality(tr.x))
        counts = launches()
        log(f"quad {name}, use_megakernel=True: UserWarning {bool(caught)}, "
            f"megakernel_fallback_reason {m['megakernel_fallback_reason']!r}"
            f", launches {counts} (want scaffold_update {per_step}, nothing "
            f"else); suboptimality " + " -> ".join(f"{s:.4e}" for s in subs))
        if (not caught or m["megakernel_fallback_reason"] != want
                or counts["scaffold_update"] != per_step
                or sum(counts.values()) != per_step
                or not all(math.isfinite(v) for v in subs)):
            raise AssertionError(f"quad {name}: {m}, {counts}")
        if per_step:
            result.setdefault("b1_paths", {})[f"quadratics {name}"] = per_step


# the paper's Table 5 at benchmarks/table5_nn.py's full settings: the
# 784-256-62 MLP, N 50 of 20,000 samples, S 10, K 25, eta_l 0.3, batch
# 0.2 of a shard, 150 rounds; the scanned engine (phase 23) runs all 150
# in chunks of 5, test accuracy every 5 rounds; the sync host loop (phase
# 16) the first 20 (30 until the serving phases came: cut to keep the
# script in its time limit), test accuracy every 10
EMNIST = dict(num_clients=50, samples=20_000, seed=0)
EMNIST_ROUNDS, EMNIST_SCAN_CHUNK = 150, 5
EMNIST_SYNC_ROUNDS, EMNIST_EVAL_EVERY = 15, 5
EMNIST_SPEC = dict(num_clients=50, num_sampled=10, local_steps=25, eta_l=0.3)
# the MLP's leaves: w1 784x256, b1 256, w2 256x62, b2 62
MLP_PARAMS = 784 * 256 + 256 + 256 * 62 + 62


def _mlp_trainer(spec, data, device="cuda", init=None, fused=True, **kw):
    """A trainer of the EMNIST MLP, its weights from a seed-0 generator
    (or ``init``, a tree copied to ``device``); ``fused`` False runs the
    plain update in place of B1/B2; ``kw`` the trainer's engine flags."""
    import torch

    from repro_torch.core import FederatedTrainer
    from repro_torch.models import simple

    def init_params(gen):
        if init is not None:
            return {k: v.clone() for k, v in init.items()}
        return simple.mlp_init(gen, 784, 62, device=gen.device)

    return FederatedTrainer(simple.mlp_loss, init_params, spec, data, seed=0,
                            use_fused_update=fused, device=device, **kw)


def _time_small_trees(fns, host_call, quad_call):
    """Card time a call (``card_ms``, L2 flushed) of each of ``fns`` in
    turns, the wrapper's host time a call of ``host_call`` (median of 30
    calls by the host clock, the card idle before each), and the card
    time of ``quad_call``: medians, and the kernel's turns."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    dev = {k: [] for k in fns}
    for turn in range(4):
        for k in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            dev[k].append(card_ms(fns[k], 20, flush, 1_000_000))
    host = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_call()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    quad = [card_ms(quad_call, 20, flush, 1_000_000) for _ in range(4)]
    out = {k: statistics.median(v) for k, v in dev.items()}
    out.update(host_us=1e6 * statistics.median(host),
               quad=statistics.median(quad), turns=dev["kernel"])
    return out


def _time_b1_mlp(tr, eta, result):
    """B1 at the MLP tree (216,894 fp32, one dtype group): card time a
    call (``card_ms``, L2 flushed) of the kernel, its plain version, its
    empty launch (the same leaf table and grid, no work) and
    ``torch._foreach_add_(ys, gs)`` in turns, 0 ulp against the plain
    version, beside its bound by bytes: y, g and the correction read, y
    written; the wrapper's host time a call; and the card time at the
    quadratics' 1024-element leaf."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    y = {k: v.clone() for k, v in tr.x.items()}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda")
         for k, v in y.items()}
    corr = {k: torch.randn(v.shape, generator=gen, device="cuda")
            for k, v in y.items()}
    out = ops.scaffold_update_packed(y, g, corr, eta)
    worst = max(ulp_distance(out[k], ref.scaffold_update_ref(
        y[k], g[k], corr[k], eta)) for k in y)
    err = max(float((out[k] - ref.scaffold_update_ref(
        y[k], g[k], corr[k], eta)).abs().max()) for k in y)
    if worst != 0:
        raise AssertionError(f"B1 at the MLP tree: {worst} ulp from plain")
    (plan,) = ops.plans(y, g, corr)
    ys, gs = list(y.values()), list(g.values())
    q = [torch.randn(1024, generator=gen, device="cuda") for _ in range(3)]

    def kernel():
        ops.scaffold_update_packed(y, g, corr, eta, out=y)

    t = _time_small_trees(
        {"kernel": kernel,
         "plain": lambda: [ref.scaffold_update_ref(y[k], g[k], corr[k], eta)
                           for k in y],
         "floor": lambda: ops.launch_floor(plan),
         "foreach_add": lambda: torch._foreach_add_(ys, gs, alpha=-eta)},
        kernel, lambda: ops.scaffold_update(*q, eta, out=q[0]))
    n = sum(v.numel() for v in y.values())
    nbytes = 4 * n * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"scaffold_update at the MLP tree ({n} fp32, {len(y)} leaves, 1 "
        f"group; grid {plan.grid} over {plan.first[-1]} chunks, table of "
        f"{plan.capacity}): card time a call, kernel {spread(t['turns'])}, "
        f"its empty launch {t['floor']:.4f}, plain {t['plain']:.4f}, "
        f"torch._foreach_add_(ys, gs) {t['foreach_add']:.4f} ms; bound "
        f"{bound:.5f} ms (bytes, {nbytes / 1e6:.2f} MB: 4 tree-sized passes, "
        f"L2 flushed); wrapper host time {t['host_us']:.1f} us a call; the "
        f"1024 leaf {t['quad']:.4f} ms card time; kernel vs plain 0 ulp "
        f"(max |diff| {err:.1e})")
    result["b1"].update(
        mlp_ms=t["kernel"], mlp_plain_ms=t["plain"], mlp_bound_ms=bound,
        mlp_floor_ms=t["floor"], mlp_foreach_add_ms=t["foreach_add"],
        host_us=t["host_us"], quad_ms=t["quad"],
        quad_bound_ms=4 * 1024 * 4 / HBM_BYTES_PER_S * 1e3)


def _time_b2_mlp(tr, spec, result):
    """B2 at the MLP tree (216,894 fp32, fp32 slot, one dtype group), as
    phase 17's local heavy-ball runs it: against the plain version
    (bounds 1 ulp in y', 0 ulp in m', as phase 4), then timed as B1 in
    phase 16 (``_time_b1_mlp``), beside its bound by bytes: y, g, the
    correction and m read, y' and m' written."""
    import torch

    from repro_torch.kernels.scaffold_update import ops, ref

    eta, beta = spec.eta_l, spec.local_momentum
    gen = torch.Generator(device="cuda").manual_seed(8)
    y = {k: v.clone() for k, v in tr.x.items()}
    g, corr, m = ({k: torch.randn(v.shape, generator=gen, device="cuda")
                   for k, v in y.items()} for _ in range(3))
    out_y, out_m = ops.scaffold_momentum_update_packed(y, g, corr, m, eta,
                                                       beta)
    want_y, want_m = ref.scaffold_momentum_update_tree_ref(y, g, corr, m,
                                                           eta, beta)
    uy = max(ulp_distance(out_y[k], want_y[k]) for k in y)
    um = max(ulp_distance(out_m[k], want_m[k]) for k in y)
    err = max(max(float((out_y[k] - want_y[k]).abs().max()),
                  float((out_m[k] - want_m[k]).abs().max())) for k in y)
    log(f"scaffold_momentum_update at the MLP tree: worst leaf {uy} ulp in "
        f"y', {um} ulp in m' (bounds 1 and 0), max |kernel - plain| "
        f"{err:.1e}")
    if uy > 1 or um > 0:
        raise AssertionError(f"B2 at the MLP tree: {uy}/{um} ulp (y', m')")
    (plan,) = ops.plans(y, g, corr, m)
    ys, gs = list(y.values()), list(g.values())
    q = [torch.randn(1024, generator=gen, device="cuda") for _ in range(4)]

    def kernel():
        ops.scaffold_momentum_update_packed(y, g, corr, m, eta, beta, out=y,
                                            m_out=m)

    t = _time_small_trees(
        {"kernel": kernel,
         "plain": lambda: ref.scaffold_momentum_update_tree_ref(
             y, g, corr, m, eta, beta),
         "floor": lambda: ops.launch_floor(plan, momentum=True),
         "foreach_add": lambda: torch._foreach_add_(ys, gs, alpha=-eta)},
        kernel, lambda: ops.scaffold_momentum_update(
            *q, eta, beta, out=q[0], m_out=q[3]))
    n = sum(v.numel() for v in y.values())
    nbytes = 6 * n * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"scaffold_momentum_update at the MLP tree ({n} fp32, fp32 slot, "
        f"{len(y)} leaves, 1 group; grid {plan.grid}): card time a call, "
        f"kernel {spread(t['turns'])}, its empty launch {t['floor']:.4f}, "
        f"plain {t['plain']:.4f}, torch._foreach_add_(ys, gs) "
        f"{t['foreach_add']:.4f} ms; bound {bound:.5f} ms (bytes, "
        f"{nbytes / 1e6:.2f} MB: 6 tree-sized passes, L2 flushed); wrapper "
        f"host time {t['host_us']:.1f} us a call; the 1024 leaf "
        f"{t['quad']:.4f} ms card time")
    result["b2"].update(
        mlp_ms=t["kernel"], mlp_plain_ms=t["plain"], mlp_bound_ms=bound,
        mlp_max_abs_err=err, mlp_floor_ms=t["floor"],
        mlp_foreach_add_ms=t["foreach_add"], host_us=t["host_us"],
        quad_ms=t["quad"], quad_bound_ms=6 * 1024 * 4 / HBM_BYTES_PER_S * 1e3)


def phase_emnist_table5(result):
    """Phase 16: the paper's Table 5 on the card, its first 15 rounds
    through the sync host loop (phase 23 runs all 150 scanned). SGD
    (whole batch, K 1), FedAvg and SCAFFOLD at similarity 0 and 10; every
    SCAFFOLD local step through B1 (FedAvg and SGD have no correction, so
    no fused step). Fails on a non-finite loss, on B1 launches other than
    rounds x S x K for SCAFFOLD and 0 otherwise, and on a best accuracy of
    FedAvg or SCAFFOLD at or under 0.10 (chance is 1/62). Keeps each
    row's median s/round for phase 23."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.data import EmnistLikeFederated
    from repro_torch.models import simple

    best_all = {}
    log(f"reduced: Table 5 sync rounds 30 -> {EMNIST_SYNC_ROUNDS}, test "
        f"accuracy every {EMNIST_EVAL_EVERY} (the "
        f"script's time limit; phase 23 runs all 150 scanned)")
    for sim in (0.0, 10.0):
        t0 = time.perf_counter()
        data = EmnistLikeFederated(similarity_pct=sim, **EMNIST)
        lb = data.local_batch_size(0.2)
        tb = data.test_batch(device="cuda")
        sizes = data.client_sizes(range(EMNIST["num_clients"]))
        log(f"emnist sim {sim:g}%: data built in {time.perf_counter() - t0:.1f}"
            f" s; shards {sizes.min()}-{sizes.max()}, local batch {lb}, test "
            f"batch {tb['x'].shape[0]}")
        for algo, K in (("sgd", 1), ("fedavg", 25), ("scaffold", 25)):
            spec = FedRoundSpec(algorithm=algo, local_batch=lb,
                                **{**EMNIST_SPEC, "local_steps": K})
            tr = _mlp_trainer(spec, data)
            reset_launches()
            secs, accs = [], []
            for r in range(EMNIST_SYNC_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = tr.run_round()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                if not math.isfinite(m["loss"]):
                    raise AssertionError(f"emnist {algo} sim {sim}: round "
                                         f"{r + 1} loss {m['loss']}")
                if (r + 1) % EMNIST_EVAL_EVERY == 0:
                    accs.append(simple.accuracy(simple.mlp_logits, tr.x, tb))
            counts = launches()
            want = {k: 0 for k in counts}
            if algo == "scaffold":
                want["scaffold_update"] = (EMNIST_SYNC_ROUNDS
                                           * spec.num_sampled
                                           * spec.local_steps)
                paths = result.setdefault("b1_paths", {})
                paths["emnist table 5"] = (paths.get("emnist table 5", 0)
                                           + counts["scaffold_update"])
            best = max(accs)
            best_all[(algo, sim)] = best
            log(f"emnist table 5, sim {sim:g}%, {algo} (K {K}): best test "
                f"accuracy {best:.4f} (every {EMNIST_EVAL_EVERY} rounds: "
                + ", ".join(f"{a:.3f}" for a in accs)
                + f"); final loss {m['loss']:.4f}; s/round median of rounds "
                f"2-{EMNIST_SYNC_ROUNDS} {statistics.median(secs[1:]):.4f} "
                f"(round 1 {secs[0]:.3f}); launches {counts}")
            result.setdefault("table5_sync_s", {})[(algo, sim)] = (
                statistics.median(secs[1:]))
            if counts != want:
                raise AssertionError(f"emnist {algo}: launches {counts} != "
                                     f"{want}")
            if algo != "sgd" and not best > 0.10:
                raise AssertionError(f"emnist {algo} sim {sim}: best "
                                     f"accuracy {best}")
            if algo == "scaffold" and sim == 0.0:
                _time_b1_mlp(tr, spec.eta_l, result)
                _profile_round(tr, "emnist", kernels=("scaffold_update",),
                               want={"scaffold_update_kernel":
                                     spec.num_sampled * spec.local_steps},
                               tries=3)
            tr.close()
            del tr
        del data, tb
    for sim in (0.0, 10.0):
        order = sorted(("sgd", "fedavg", "scaffold"),
                       key=lambda a: -best_all[(a, sim)])
        log(f"emnist table 5, sim {sim:g}%: best accuracy order "
            + " > ".join(f"{a} {best_all[(a, sim)]:.4f}" for a in order)
            + f" after {EMNIST_SYNC_ROUNDS} rounds (the paper's: scaffold "
            f"> fedavg > sgd; not asserted)")
    torch.cuda.empty_cache()


def _closed_form_epsilon(spec, rounds: int) -> float:
    """The accountant's bound, eps = A + 2 sqrt(A ln(1/delta)), A =
    2 T q^2 / z^2, q = S/N, in float64."""
    q = spec.num_sampled / spec.num_clients
    a = 2.0 * rounds * q * q / spec.noise_multiplier ** 2
    return a + 2.0 * math.sqrt(a * math.log(1.0 / spec.dp_delta))


def _numpy_normals(kind, path, shape):
    """Draws that do not depend on the device: normals from numpy, seeded
    by the fold path (the card-vs-CPU round injects them on both)."""
    import numpy as np

    assert kind == "normal", kind
    return np.random.default_rng(list(path)).standard_normal(
        shape, dtype=np.float32)


def _hidden_units_apart(xa, xb, tol):
    """The MLP's hidden units holding an element of ``xa`` that differs
    from ``xb`` by more than ``tol`` of its leaf's largest |value| (w1's
    columns, b1's entries, w2's rows)."""
    axis = {"w1": 0, "b1": None, "w2": 1}
    units = set()
    for k, red in axis.items():
        far = (xa[k] - xb[k]).abs() > tol * xb[k].abs().max()
        if red is not None:
            far = far.any(dim=red)
        units.update(far.nonzero()[:, 0].tolist())
    return units


def phase_emnist_codecs(result):
    """Phase 17: compression and privacy on the EMNIST MLP, SCAFFOLD, N 50,
    S 10, K 25, 3 rounds a case. Fails unless: the bytes metrics equal
    ``round_comm_bytes`` as ints; the residual rows of round 1's cohort
    are non-zero after it and a later round reads them back as stored;
    every clipped client's measured norm is at most C; ``dp_epsilon`` is
    the float64 closed form; B1 (B2 under local heavy-ball) launched
    rounds x S x K times and nothing else; B2 at the MLP tree is within
    1 ulp (y') and 0 ulp (m') of its plain version; one round of int8 +
    server noise on the card is within 1e-4 of the same round on the
    CPU; one local heavy-ball round through B2 equals the same round
    through the plain update on the card, bitwise."""
    import numpy as np
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import get_privatizer, round_comm_bytes, streams
    from repro_torch.core.privatizer import global_norm
    from repro_torch.data import EmnistLikeFederated

    data = EmnistLikeFederated(similarity_pct=10.0, **EMNIST)
    lb = data.local_batch_size(0.2)
    rounds = 3
    dp = dict(clip_norm=1.0, noise_multiplier=1.0)
    cases = (
        ("int8_ef up", dict(compress="int8_ef")),
        ("topk_ef up (k 32)", dict(compress="topk_ef", compress_k=32)),
        ("randk_ef up (k 32)", dict(compress="randk_ef", compress_k=32)),
        ("sign_ef up", dict(compress="sign_ef")),
        ("int8_ef both ways", dict(compress="int8_ef",
                                   compress_downlink="int8_ef")),
        ("server_gauss + int8_ef", dict(compress="int8_ef",
                                        privatizer="server_gauss", **dp)),
        ("distributed_gauss + int8_ef", dict(
            compress="int8_ef", privatizer="distributed_gauss", **dp)),
        ("scaffold_m, local heavy-ball", dict(
            algorithm="scaffold_m", local_solver="momentum",
            local_momentum=0.9)),
    )
    for name, changes in cases:
        spec = FedRoundSpec(**{**dict(EMNIST_SPEC, algorithm="scaffold",
                                      local_batch=lb), **changes})
        tr = _mlp_trainer(spec, data)
        priv = get_privatizer(spec.privatizer)
        norms, read_back = [], []
        if priv.clips:
            clip = priv.clip

            def recording_clip(sp, dy, clip=clip):
                out, flag = clip(sp, dy)
                norms.append(float(global_norm(out)))
                return out, flag

            priv.clip = recording_clip
        stored = {}  # client id -> its residual row after its last round
        if tr.residual_store is not None:
            gather = tr.residual_store.gather

            def recording_gather(ids, gather=gather):
                rows = gather(ids)
                for j, cid in enumerate(np.asarray(ids).tolist()):
                    if cid in stored:
                        read_back.append(all(torch.equal(
                            rows[k][j], stored[cid][k]) for k in rows))
                return rows

            tr.residual_store.gather = recording_gather
        cohorts, sample = [], tr.sampler.sample
        tr.sampler.sample = lambda: cohorts.append(sample()) or cohorts[-1]
        reset_launches()
        try:
            for r in range(rounds):
                m = tr.run_round()
                ids = cohorts[-1]
                if not math.isfinite(m["loss"]):
                    raise AssertionError(f"codecs {name}: loss {m}")
                want_bytes = round_comm_bytes(spec, tr.x,
                                              stateful_clients=True)
                if (int(m["bytes_up"]), int(m["bytes_down"])) != (
                        want_bytes["bytes_up"], want_bytes["bytes_down"]):
                    raise AssertionError(f"codecs {name}: bytes {m} != "
                                         f"{want_bytes}")
                if priv.name != "none" and m["dp_epsilon"] != (
                        _closed_form_epsilon(spec, r + 1)):
                    raise AssertionError(f"codecs {name}: dp_epsilon "
                                         f"{m['dp_epsilon']}")
                if tr.residual_store is not None:
                    rows = tr.residual_store.all_rows()
                    for cid in ids.tolist():
                        stored[cid] = {k: v[cid].clone()
                                       for k, v in rows.items()}
                    if r == 0 and not all(
                            any(bool(v[cid].any()) for v in rows.values())
                            for cid in ids.tolist()):
                        raise AssertionError(f"codecs {name}: a zero "
                                             f"residual row after round 1")
        finally:
            if priv.clips:
                priv.clip = clip
        counts = launches()
        kernel = ("scaffold_momentum_update" if spec.local_solver ==
                  "momentum" else "scaffold_update")
        want = {k: 0 for k in counts}
        want[kernel] = rounds * spec.num_sampled * spec.local_steps
        paths = result.setdefault("b1_paths" if kernel == "scaffold_update"
                                  else "b2_paths", {})
        paths["emnist codecs"] = paths.get("emnist codecs", 0) + counts[kernel]
        extra = ""
        if priv.clips:
            extra += (f"; clipped norms: {len(norms)}, largest "
                      f"{max(norms)!r} (C {spec.clip_norm}); dp_clipped_frac "
                      f"{m['dp_clipped_frac']:.3f}; dp_epsilon "
                      f"{m['dp_epsilon']!r} == closed form")
        if tr.residual_store is not None:
            extra += (f"; residual rows read back {sum(read_back)} of "
                      f"{len(read_back)} re-sampled clients, as stored")
        log(f"codecs {name}: loss {m['loss']:.4f}, bytes up "
            f"{int(m['bytes_up'])} down {int(m['bytes_down'])} (== "
            f"round_comm_bytes); launches {counts}{extra}")
        if counts != want:
            raise AssertionError(f"codecs {name}: launches {counts} != "
                                 f"{want}")
        if norms and not max(norms) <= spec.clip_norm:
            raise AssertionError(f"codecs {name}: clipped norm {max(norms)}")
        if tr.residual_store is not None and not (read_back
                                                  and all(read_back)):
            raise AssertionError(f"codecs {name}: residual rows read back "
                                 f"{read_back}")
        if kernel == "scaffold_momentum_update":
            _time_b2_mlp(tr, spec, result)
        tr.close()
        del tr

    # one round of int8 + server noise, card against CPU, same weights
    # and the same (injected) normals
    from repro_torch.models import simple

    init = simple.mlp_init(torch.Generator().manual_seed(0), 784, 62,
                           device="cpu")
    spec = FedRoundSpec(**dict(EMNIST_SPEC, algorithm="scaffold",
                               local_batch=lb, compress="int8_ef",
                               privatizer="server_gauss", **dp))
    xs = {}
    with streams.injected(_numpy_normals):
        for dev in ("cuda", "cpu"):
            tr = _mlp_trainer(spec, data, device=dev, init=init)
            tr.run_round()
            xs[dev] = {k: v.cpu() for k, v in tr.x.items()}
            tr.close()
            del tr
    err = max(rel_err(xs["cuda"][k], xs["cpu"][k]) for k in init)
    log(f"codecs card vs CPU: one int8_ef + server_gauss round, injected "
        f"normals: max leaf rel err of x {err:.2e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"codecs card vs CPU rel err {err}")

    # one local heavy-ball round (scaffold_m) through B2 against the same
    # round through the plain update on the card: x and every client's
    # slot row bitwise equal. Against the CPU it is printed, not held:
    # heavy-ball at eta_l 0.3, beta 0.9 carries the two devices' ~1e-6
    # GEMM-order differences across relu kinks, so whole hidden units
    # part (on an H100: 9.27e-03, all of it in 2 of the 256 units, while
    # the gradients at equal inputs agree to ~1e-6 and the plain update's
    # round differs from the CPU's alike). tests/test_torch_kernels_gpu.py
    # holds a K 5 heavy-ball round to the CPU at 1e-4
    spec = FedRoundSpec(**dict(EMNIST_SPEC, algorithm="scaffold_m",
                               local_batch=lb, local_solver="momentum",
                               local_momentum=0.9))
    out = {}
    for tag, dev, fused in (("B2", "cuda", True), ("plain", "cuda", False),
                            ("cpu", "cpu", True)):
        tr = _mlp_trainer(spec, data, device=dev, init=init, fused=fused)
        tr.run_round()
        out[tag] = ({k: v.cpu() for k, v in tr.x.items()},
                    tr.solver_store.gather(np.arange(spec.num_clients)))
        tr.close()
        del tr
    (xb, mb), (xp, mp), (xc, _) = out["B2"], out["plain"], out["cpu"]
    same = (all(torch.equal(xb[k], xp[k]) for k in xb)
            and all(torch.equal(mb[k], mp[k]) for k in mb))
    err = max(rel_err(xb[k], xc[k]) for k in xb)
    units = sorted(_hidden_units_apart(xb, xc, 1e-4))
    log(f"codecs heavy-ball round on the card: B2 vs plain update, x and "
        f"slot rows {'bitwise equal' if same else 'DIFFER'}; vs the CPU "
        f"(not held) max leaf rel err of x {err:.2e}, elements beyond 1e-4 "
        f"of their leaf's max in hidden units {units} of 256")
    if not same:
        raise AssertionError("codecs heavy-ball round: B2 differs from the "
                             "plain update on the card")
    del data
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the scanned engine: each round one replay of a captured CUDA graph
# ---------------------------------------------------------------------------


def host_loop_device_rng(spec, ds, rounds, loss_fn, init_params, *,
                         fused=True, device="cuda", seed=0):
    """``rounds`` calls of ``run_round`` on ``device``, eagerly, on the
    scanned engine's streams (cohorts at path (seed, t), data at (seed +
    1, t) through the dataset's ``device_batch_fn``, the keyed streams at
    seed + 2 and seed + 3), every row family gathered from and scattered
    to host stores: the per-round host loop a scanned trainer is held to.
    The weights are ``init_params`` of a generator seeded ``seed`` on
    ``device``, as the trainer makes them. Returns ``(server, {family:
    (N, ...) rows}, history)``."""
    import torch

    from repro_torch.core import (
        ClientRoundState,
        ClientStateStore,
        device_sample_ids,
        get_compressor,
        get_local_solver,
        init_server_state,
        make_grad_fn,
        resolve_local_solver,
        run_round,
    )
    from repro_torch.core.streams import round_key, stream_key
    from repro_torch.core.tree import tree_flatten_slots

    dev = torch.device(device)
    grad_fn = make_grad_fn(loss_fn)
    data = ds.device_data(device=dev)
    batch_fn = ds.device_batch_fn(spec.local_steps, spec.local_batch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {k: v.to(dev) for k, v in init_params(gen).items()}
    server = init_server_state(spec, params)
    stores = {"c_i": ClientStateStore(params, spec.num_clients)}
    if get_compressor(spec.compress).stateful:
        stores["residual"] = ClientStateStore(
            {k: v.float() for k, v in params.items()}, spec.num_clients)
    solver = get_local_solver(resolve_local_solver(spec))
    if solver.stateful:
        stores["solver"] = ClientStateStore(
            tree_flatten_slots(solver.init(spec, params)), spec.num_clients)
    sizes = (ds.device_client_sizes(device=dev)
             if spec.weighted_aggregation else None)
    skey, dkey = stream_key(seed, dev), stream_key(seed + 1, dev)
    hist = []
    for t in range(rounds):
        ids = device_sample_ids(skey, t, spec.num_clients, spec.num_sampled)
        batches = batch_fn(data, ids, dkey.fold_in(t))
        rows = {name: st.gather(ids) for name, st in stores.items()}
        out = run_round(grad_fn, spec, server, ClientRoundState(
            c_i=rows["c_i"], uplink_residual=rows.get("residual"),
            solver_slots=rows.get("solver"),
            weights=None if sizes is None else sizes[ids]), batches,
            use_fused_update=fused, comp_key=round_key(seed + 2, t, dev),
            priv_key=round_key(seed + 3, t, dev), dp_round=t)
        server = out.server
        new = {"c_i": out.clients.c_i,
               "residual": out.clients.uplink_residual,
               "solver": out.clients.solver_slots}
        for name, st in stores.items():
            st.scatter(ids, new[name])
        hist.append({k: float(v) for k, v in out.metrics.items()})
    return server, {name: st.all_rows() for name, st in stores.items()}, hist


def _flat(tree, prefix=""):
    """Nested dicts of tensors -> ``{"a/b": tensor}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def scanned_vs_host_loop(tr, server, rows) -> dict:
    """Leaves of a scanned trainer's state (x, c, optimizer slots, every
    store row family) against the host loop's: ``{"leaves", "apart",
    "max_abs", "max_rel"}``, ``apart`` counting leaves not bitwise equal,
    ``max_rel`` the largest |diff| over its leaf's largest magnitude."""
    import torch

    got = _flat({"x": tr.x, "c": tr.c, "opt": tr.server.opt_state,
                 "store": tr._device_families()})
    want = _flat({"x": server.x, "c": server.c, "opt": server.opt_state,
                  "store": rows})
    if sorted(got) != sorted(want):
        raise AssertionError(f"scanned vs host loop: leaves {sorted(got)} "
                             f"vs {sorted(want)}")
    apart, max_abs, max_rel = 0, 0.0, 0.0
    for k, v in want.items():
        g = got[k].detach().cpu()
        v = v.detach().cpu()
        if not torch.equal(g, v):
            apart += 1
            diff = float((g.double() - v.double()).abs().max())
            max_abs = max(max_abs, diff)
            max_rel = max(max_rel, diff / max(float(v.double().abs().max()),
                                              1e-30))
    return dict(leaves=len(want), apart=apart, max_abs=max_abs,
                max_rel=max_rel)


def _scanned(loss_fn, init, spec, ds, rounds, fused=True):
    """A scanned trainer on the card that must capture its rounds."""
    from repro_torch.core import FederatedTrainer

    tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                          use_fused_update=fused, device="cuda",
                          scan_rounds=rounds)
    if tr.scan_fallback_reason is not None or not tr.scan_captured:
        raise AssertionError(f"not a captured scanned trainer: fallback "
                             f"{tr.scan_fallback_reason!r}, graph reason "
                             f"{tr.scan_graph_reason!r}")
    return tr


def _want_launches(**nonzero) -> dict:
    """Every kernel's expected launch count: ``nonzero``, else 0."""
    return {k: nonzero.get(k, 0) for k in launches()}


def phase_fig3_scanned(result):
    """Phase 22: the paper's Figure 3 (``benchmarks/fig3_quadratics.py``'s
    own settings) through the scanned engine: ``make_paper_fig3`` at G 1,
    10 and 100; sgd K 1, fedavg K 2 and 10, scaffold K 2 and 10; N = S =
    2, eta_l 0.1, 60 rounds as one chunk, each round a replay of the
    captured graph. SCAFFOLD's steps through B1 (60 S K launches, counted
    through the replays); each scaffold row once more with the K-step
    kernel (B3, 60 S). Prints the suboptimality table as the script does;
    fails on a non-finite value, a launch count, a fallback."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import make_paper_fig3, quadratic_loss

    rounds, subs = 60, {}
    rows = (("sgd", 1), ("fedavg", 2), ("fedavg", 10), ("scaffold", 2),
            ("scaffold", 10))
    b1 = b3 = 0
    for G in (1.0, 10.0, 100.0):
        ds = make_paper_fig3(G=G)
        init = lambda gen, d=ds.dim: {"x": torch.ones(d)}  # noqa: E731
        for algo, K in rows:
            for path in (("fused", "megakernel") if algo == "scaffold"
                         else ("fused",)):
                spec = FedRoundSpec(algorithm=algo, num_clients=2,
                                    num_sampled=2, local_steps=K,
                                    local_batch=1, eta_l=0.1,
                                    use_megakernel=path == "megakernel")
                tr = _scanned(quadratic_loss, init, spec, ds, rounds)
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.run(rounds)
                torch.cuda.synchronize()
                sec = (time.perf_counter() - t0) / rounds
                counts = launches()
                want = _want_launches()
                if algo == "scaffold" and path == "fused":
                    want["scaffold_update"] = rounds * 2 * K
                elif algo == "scaffold":
                    want["scaffold_local_loop"] = rounds * 2
                sub = ds.suboptimality(tr.x)
                subs[(G, algo, K, path)] = sub
                log(f"fig3 scanned G={G:g} {algo}-K{K} ({path}): "
                    f"suboptimality {sub:.4e} after {rounds} rounds in one "
                    f"chunk; captured {tr.scan_captured}; {sec:.5f} s/round "
                    f"(the chunk's host clock over its rounds, warm-up and "
                    f"capture included); launches {counts}")
                if counts != want or not math.isfinite(sub) or (
                        tr.scan_fallback_reason is not None) or (
                        path == "megakernel"
                        and tr.megakernel_fallback_reason != ""):
                    raise AssertionError(f"fig3 {algo}-K{K} G {G} {path}: "
                                         f"{counts} vs {want}, {sub}")
                b1 += counts["scaffold_update"]
                b3 += counts["scaffold_local_loop"]
                if (G, algo, K, path) == (10.0, "scaffold", 10, "fused"):
                    result["fig3_scan_s"] = sec
                tr.close()
    # the sync host loop on one row, for its s/round
    ds = make_paper_fig3(G=10.0)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=2, num_sampled=2,
                        local_steps=10, local_batch=1, eta_l=0.1)
    tr = FederatedTrainer(quadratic_loss, lambda gen: {"x": torch.ones(
        ds.dim)}, spec, ds, seed=0, use_fused_update=True, device="cuda")
    secs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    result["fig3_sync_s"] = statistics.median(secs[1:])
    log(f"fig3 G=10 scaffold-K10 (fused): the sync host loop "
        f"{result['fig3_sync_s']:.5f} s/round (median of rounds 2-{rounds})"
        f", the scanned chunk {result['fig3_scan_s']:.5f} s/round")
    log("fig3 scanned: suboptimality after rounds (rows: algo-K, cols: G)")
    gs = (1.0, 10.0, 100.0)
    log(f"{'algo':>24s} " + " ".join(f"G={g:<10.0f}" for g in gs))
    for algo, K in rows:
        for path in (("fused", "megakernel") if algo == "scaffold"
                     else ("fused",)):
            label = f"{algo}-K{K}" + (" (B3)" if path == "megakernel" else "")
            log(f"{label:>24s} " + " ".join(
                f"{subs[(g, algo, K, path)]:<12.3e}" for g in gs))
    result.setdefault("b1_paths", {})["fig3 scanned"] = b1
    result.setdefault("b3_paths", {})["fig3 scanned"] = b3


class _EventTimedGraph:
    """A round graph whose every replay is bracketed by CUDA events."""

    def __init__(self, graph):
        self.graph, self.spans = graph, []

    def replay(self):
        import torch

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.spans.append((a, b))


def _busy_share(tr, chunks: int = 3):
    """The card-busy share of a captured trainer's chunks: ``chunks``
    more chunks of its size, each replay bracketed by CUDA events; the
    sum of the replays' device spans over the chunk's host-clock wall
    (the card synchronised on both sides), the median over the chunks.
    Returns ``(share, ms of card time a round)``."""
    import torch

    timed = tr._graph = _EventTimedGraph(tr._graph)
    shares, per_round = [], []
    for _ in range(chunks):
        timed.spans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(tr.scan_rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = sum(a.elapsed_time(b) for a, b in timed.spans) / 1e3
        shares.append(busy / wall)
        per_round.append(1e3 * busy / len(timed.spans))
    tr._graph = timed.graph
    return statistics.median(shares), statistics.median(per_round)


def phase_table5_scanned(result):
    """Phase 23: the paper's Table 5 (``benchmarks/table5_nn.py``'s
    settings, uncut) through the scanned engine: N 50 of 20,000 samples at
    similarity 0 and 10, the MLP, S 10, batch 0.2 of a shard, eta_l 0.3,
    150 rounds in chunks of 5 (``scan_rounds=5``), test accuracy every 5
    rounds; SGD (K 1), FedAvg and SCAFFOLD (K 25), SCAFFOLD's steps
    through B1 (150 x 10 x 25 launches, counted through the replays).
    Logs s/round (the host clock over a synchronised chunk, over its
    rounds) against phase 16's sync figure and the card-busy share (the
    replays' spans between CUDA events over a chunk's wall). Fails on a
    non-finite loss, a launch count, a best accuracy of FedAvg or
    SCAFFOLD at or under 0.10; on SCAFFOLD at 0 % a checkpoint after 7
    rounds (mid-chunk), restored into a fresh trainer that runs to round
    15, must equal the unbroken run there bitwise."""
    import torch

    from repro_torch.checkpoint import load_trainer, save_trainer
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.data import EmnistLikeFederated
    from repro_torch.models import simple

    chunk = EMNIST_SCAN_CHUNK
    best_all, b1 = {}, 0
    for sim in (0.0, 10.0):
        data = EmnistLikeFederated(similarity_pct=sim, **EMNIST)
        lb = data.local_batch_size(0.2)
        tb = data.test_batch(device="cuda")
        for algo, K in (("sgd", 1), ("fedavg", 25), ("scaffold", 25)):
            spec = FedRoundSpec(algorithm=algo, local_batch=lb,
                                **{**EMNIST_SPEC, "local_steps": K})
            tr = _mlp_trainer(spec, data, scan_rounds=chunk)
            if not tr.scan_captured:
                raise AssertionError(f"table 5 scanned {algo}: not captured "
                                     f"({tr.scan_graph_reason})")
            reset_launches()
            secs, accs, snap = [], [], None
            for c in range(EMNIST_ROUNDS // chunk):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.run(chunk)
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0) / chunk)
                m = tr.history[-1]
                if not math.isfinite(m["loss"]):
                    raise AssertionError(f"table 5 scanned {algo} sim {sim}:"
                                         f" round {tr.round_idx} {m}")
                accs.append(simple.accuracy(simple.mlp_logits, tr.x, tb))
                if tr.round_idx == 15 and algo == "scaffold" and sim == 0.0:
                    snap = {k: v.clone() for k, v in _flat(
                        {"x": tr.x, "c": tr.c,
                         "store": tr._device_families()}).items()}
            counts = launches()
            want = _want_launches()
            if algo == "scaffold":
                want["scaffold_update"] = (EMNIST_ROUNDS * spec.num_sampled
                                           * spec.local_steps)
                b1 += counts["scaffold_update"]
            best = best_all[(algo, sim)] = max(accs)
            sync = result["table5_sync_s"][(algo, sim)]
            steady = statistics.median(secs[1:])
            log(f"table 5 scanned, sim {sim:g}%, {algo} (K {K}): best test "
                f"accuracy {best:.4f} (every {chunk} rounds, last "
                + ", ".join(f"{a:.3f}" for a in accs[-6:])
                + f"); final loss {m['loss']:.4f}; captured "
                f"{tr.scan_captured}; s/round {steady:.5f} (median of chunks "
                f"2-{len(secs)}; chunk 1 {secs[0]:.4f}, warm-up and capture) "
                f"against the sync loop's {sync:.5f} (phase 16): "
                f"{sync / steady:.1f}x; launches {counts}")
            if counts != want:
                raise AssertionError(f"table 5 scanned {algo}: {counts} != "
                                     f"{want}")
            if algo != "sgd" and not best > 0.10:
                raise AssertionError(f"table 5 scanned {algo} sim {sim}: "
                                     f"best accuracy {best}")
            result.setdefault("table5_scan_s", {})[(algo, sim)] = steady
            if algo == "scaffold" and sim == 0.0:
                ckpt = OUT / "table5_scan_ckpt"
                a = _mlp_trainer(spec, data, scan_rounds=chunk)
                a.run(7)
                save_trainer(str(ckpt), a)
                b = _mlp_trainer(spec, data, scan_rounds=chunk)
                load_trainer(str(ckpt) + ".npz", b)
                b.run(8)
                got = _flat({"x": b.x, "c": b.c,
                             "store": b._device_families()})
                apart = [k for k, v in snap.items()
                         if not torch.equal(got[k], v)]
                log(f"table 5 scanned, scaffold sim 0%: checkpoint after 7 "
                    f"rounds (chunks 5 + 2), restored into a fresh trainer "
                    f"that ran rounds 8-15: {len(apart)} of {len(snap)} "
                    f"leaves apart from the unbroken run at round 15")
                if apart:
                    raise AssertionError(f"table 5 resume mid-chunk: {apart}")
                a.close()
                b.close()
                share, card = _busy_share(tr)
                result["table5_busy"] = share
                log(f"table 5 scanned, scaffold sim 0%: card-busy share "
                    f"{100 * share:.1f}% (3 more chunks of {chunk}, each "
                    f"replay between CUDA events, over the chunk's wall), "
                    f"{card:.3f} ms of card time a round")
            tr.close()
            del tr
        del data, tb
    for sim in (0.0, 10.0):
        order = sorted(("sgd", "fedavg", "scaffold"),
                       key=lambda a: -best_all[(a, sim)])
        log(f"table 5 scanned, sim {sim:g}%: best accuracy order "
            + " > ".join(f"{a} {best_all[(a, sim)]:.4f}" for a in order)
            + f" after {EMNIST_ROUNDS} rounds (the paper's: scaffold > "
            f"fedavg > sgd; not asserted)")
    result.setdefault("b1_paths", {})["table 5 scanned"] = b1
    torch.cuda.empty_cache()


def _held_to_host_loop(tag, tr, rounds, spec, ds, loss_fn, init, key):
    """Run a captured scanned trainer ``rounds`` rounds one at a time
    (each round timed, the card synchronised), then the eager host loop
    on the same device streams; both must launch ``key`` the same number
    of times, and the trainer's state equal the loop's bitwise. Returns
    the trainer's launches of ``key``."""
    import torch

    reset_launches()
    secs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    scan_counts = launches()
    reset_launches()
    host_secs = time.perf_counter()
    server, rows, _ = host_loop_device_rng(spec, ds, rounds, loss_fn, init)
    torch.cuda.synchronize()
    host_secs = (time.perf_counter() - host_secs) / rounds
    host_counts = launches()
    cmp = scanned_vs_host_loop(tr, server, rows)
    log(f"{tag}: scanned rounds {', '.join(f'{s:.4f}' for s in secs)} s "
        f"(1: warm-up, 2: capture and replay, then replays; captured "
        f"{tr.scan_captured}), the eager host loop on the same streams "
        f"{host_secs:.4f} s a round; launches scanned {scan_counts}, host "
        f"loop {host_counts}; {cmp['apart']} of {cmp['leaves']} leaves "
        f"apart (max |diff| {cmp['max_abs']:.3e}, rel {cmp['max_rel']:.3e})")
    if scan_counts != host_counts or scan_counts[key] == 0:
        raise AssertionError(f"{tag}: launches {scan_counts} vs "
                             f"{host_counts}")
    if cmp["apart"]:
        raise AssertionError(f"{tag}: scanned vs host loop {cmp}")
    return scan_counts[key], secs


def phase_capture_checks(result):
    """Phase 24: the heavy-ball and K-step kernels inside captured rounds,
    each trainer held bitwise to the port's eager per-round host loop on
    the same device streams: quadratics at phases 13-14's
    ``make_similarity_quadratics(20, 1024, ...)``, S 4, K 10, 3 rounds,
    through B3 (sgd) and B4 (local heavy-ball); EMNIST ``scaffold_m``
    with local heavy-ball through B2, 3 rounds."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.data import (
        EmnistLikeFederated,
        make_similarity_quadratics,
        quadratic_loss,
    )
    from repro_torch.models import simple

    ds = make_similarity_quadratics(20, 1024, delta=0.3, G=8.0, mu=0.3)
    init = lambda gen: {"x": torch.ones(ds.dim)}  # noqa: E731
    base = dict(num_clients=20, num_sampled=4, local_steps=10, local_batch=1,
                eta_l=0.1, use_megakernel=True)
    for tag, spec, key, path in (
            ("quadratics B3 scanned", FedRoundSpec(algorithm="scaffold",
                                                   **base),
             "scaffold_local_loop", "b3_paths"),
            ("quadratics B4 scanned", FedRoundSpec(
                algorithm="scaffold_m", eta_g=0.1, local_solver="momentum",
                local_momentum=0.9, **base),
             "scaffold_momentum_local_loop", "b4_paths")):
        tr = _scanned(quadratic_loss, init, spec, ds, 3)
        n, secs = _held_to_host_loop(tag, tr, 3, spec, ds, quadratic_loss,
                                     init, key)
        if n != 3 * spec.num_sampled:
            raise AssertionError(f"{tag}: {key} launched {n}")
        result.setdefault(path, {})[tag] = n
        result.setdefault("quad_scan_s", {})[tag] = secs[-1]
        tr.close()
    data = EmnistLikeFederated(similarity_pct=10.0, **EMNIST)
    spec = FedRoundSpec(algorithm="scaffold_m", local_solver="momentum",
                        local_momentum=0.9,
                        local_batch=data.local_batch_size(0.2),
                        **EMNIST_SPEC)
    tr = _mlp_trainer(spec, data, scan_rounds=3)
    init = lambda gen: simple.mlp_init(gen, 784, 62,  # noqa: E731
                                       device=gen.device)
    n, _ = _held_to_host_loop("emnist scaffold_m heavy-ball B2 scanned", tr,
                              3, spec, data, simple.mlp_loss, init,
                              "scaffold_momentum_update")
    if n != 3 * spec.num_sampled * spec.local_steps:
        raise AssertionError(f"emnist heavy-ball scanned: B2 launched {n}")
    result.setdefault("b2_paths", {})["emnist heavy-ball scanned"] = n
    tr.close()


def phase_gemma_scanned(result):
    """Phase 25: gemma3-1b at its published widths cut to 2 layers (both
    "W", so B5 runs its band path at seq 2048), SCAFFOLD, N 4, S 2, K 2,
    ``--scan-rounds 2``, 4 rounds through ``repro_torch.launch.train.main``:
    B5 inside the captured round (its launches counted through the
    replays), held to the eager host loop on the same device streams
    within 1e-4 of each leaf's scale (the LM parity's bound)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M

    base = get_config("gemma3-1b")
    seq_len, chunk, layers, rounds = 2048, base.vocab_size // 16, 2, 4
    cfg = dataclasses.replace(base, num_layers=layers,
                              loss_chunk_vocab=chunk)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _depth_cut(layers):
        t0 = time.perf_counter()
        tr = train.main(_train_argv("gemma3-1b", seq_len, rounds, chunk,
                                    "--scan-rounds", "2") + ["--log-every",
                                                             "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the scanned engine's plan: the host loop's, its device store of N
    # c_i rows and the captured round's static buffers aside
    _plan_vs_peak("gemma3-1b scanned", _lm_plan(cfg, seq_len, 1)[2],
                  torch.cuda.max_memory_allocated())
    counts = launches()
    n_w = cfg.pattern_for_layers().count("W")
    steps = tr.spec.num_sampled * tr.spec.local_steps
    # training: B5 on every W layer of every step, B1 on every step; the
    # entry point's eval after rounds 1, 2 and 4: B5 once a W layer
    want = _want_launches(swa_attention=n_w * (rounds * steps + 3),
                          scaffold_update=rounds * steps)
    log(f"gemma3-1b scanned, {layers} layers ({cfg.pattern_for_layers()}), "
        f"seq {seq_len}: {rounds} rounds in {wall:.1f} s through the entry "
        f"point (chunks 1, 1, 2; warm-up, capture, replays); captured "
        f"{tr.scan_captured}; launches {counts}, want {want}")
    if not tr.scan_captured or counts != want:
        raise AssertionError(f"gemma scanned: {counts} vs {want}")
    reset_launches()
    server, rows, _ = host_loop_device_rng(
        tr.spec, tr.dataset, rounds, partial(M.loss_fn, cfg),
        partial(M.init_params, cfg, device="cuda"))
    cmp = scanned_vs_host_loop(tr, server, rows)
    log(f"gemma3-1b scanned vs the eager host loop on the same streams: "
        f"{cmp['apart']} of {cmp['leaves']} leaves apart, max |diff| "
        f"{cmp['max_abs']:.3e}, max rel {cmp['max_rel']:.3e} (bound 1e-4); "
        f"host loop launches {launches()}")
    if not cmp["max_rel"] <= 1e-4:
        raise AssertionError(f"gemma scanned vs host loop: {cmp}")
    result.setdefault("b5_paths", {})["gemma3-1b 2 layers scanned"] = counts[
        "swa_attention"]
    result.setdefault("b1_paths", {})["gemma3-1b 2 layers scanned"] = counts[
        "scaffold_update"]
    tr.close()
    del tr, server, rows
    torch.cuda.empty_cache()


# -- the tiered store and the pipelined loop (phases 26-28) -----------------

# Table 4's population (N 100 of 20,000 samples) at its 5 % cohort, the
# MLP at full width, K 25, eta_l 0.3; batch 80 as Table 5's (Table 4's
# script takes 0.2 of a 200-sample shard, 40)
TIERED_EMNIST = dict(num_clients=100, samples=20_000, seed=0)
TIERED_SPEC = dict(num_clients=100, num_sampled=5, local_steps=25,
                   local_batch=80, eta_l=0.3)
TIERED_CHUNK, TIERED_ROUNDS = 5, 20
# benchmarks/bench_store.py's cohort (S 64, K 2, chunks of 16) at phase
# 13's width, a million clients
POP_N, POP_DIM, POP_S, POP_K, POP_CHUNK, POP_ROUNDS = (
    1_000_000, 1024, 64, 2, 16, 32)
POP_BLOCK = 1 << 16  # rows a comparison holds at a time


def host_rss_gb() -> float:
    """Resident host memory of this process now, GB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def trainer_state(tr) -> dict:
    """A trainer's x, c, optimizer slots and every population row, on the
    host: the dense scanned engine's device store mirrored, a tiered
    store's write-backs landed."""
    tr.sync_host_store()
    out = {k: v.detach().cpu().clone() for k, v in _flat(
        {"x": tr.x, "c": tr.c, "opt": tr.server.opt_state}).items()}
    for name, st in tr._store_families():
        out.update({f"{name}/{k}": v.clone()
                    for k, v in st.all_rows().items()})
    return out


def _apart(a: dict, b: dict) -> list:
    """Keys of two flat states not bitwise equal (all of them when the
    keys differ)."""
    import torch

    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return [k for k in a if not torch.equal(a[k], b[k])]


def _history(tr) -> list:
    return [{k: v for k, v in m.items() if k != "round"} for m in tr.history]


def _timed_chunks(tr, rounds: int, chunk: int) -> list:
    """Run ``rounds`` in chunks of ``chunk``, each timed on the host clock
    between card synchronisations; seconds a round of each chunk."""
    import torch

    secs = []
    for _ in range(rounds // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(chunk)
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) / chunk)
    return secs


def phase_tiered_emnist(result):
    """Phase 26: the tiered store's scanned engine bitwise the dense one
    on the card, at the EMNIST MLP's full width: N 100 of 20,000 samples
    (similarity 0), S 5 (Table 4's 5 %), K 25, batch 80, eta_l 0.3, 20
    rounds in chunks of 5, so the cohort buffer holds 25 of 100 rows.
    SCAFFOLD through B1; scaffold_m with int8_ef and local heavy-ball
    through B2 (three row families). Each must equal the dense engine in
    x, c, every row family and the metric history, with the same
    launches; SCAFFOLD also at gather-ahead depths 1 and 4 (2 is the
    default), over the memmap and sharded backends, and resumed from a
    checkpoint after 7 rounds. Logs s/round of both engines, the card-busy
    share and ``client_store_device_bytes``."""
    import torch

    from repro_torch.checkpoint import load_trainer, save_trainer
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.data import EmnistLikeFederated

    data = EmnistLikeFederated(similarity_pct=0.0, **TIERED_EMNIST)
    R, rounds = TIERED_CHUNK, TIERED_ROUNDS
    paths = {"b1_paths": 0, "b2_paths": 0}
    for tag, change, key, path in (
            ("scaffold", dict(algorithm="scaffold"), "scaffold_update",
             "b1_paths"),
            ("scaffold_m int8_ef heavy-ball",
             dict(algorithm="scaffold_m", compress="int8_ef",
                  local_solver="momentum", local_momentum=0.9),
             "scaffold_momentum_update", "b2_paths")):
        spec = FedRoundSpec(**TIERED_SPEC, **change)
        want_n = rounds * spec.num_sampled * spec.local_steps
        runs, trainers = {}, {}
        variants = [("dense", {}), ("tiered", dict(store="tiered"))]
        if tag == "scaffold":
            variants += [
                ("tiered depth 1", dict(store="tiered", prefetch_depth=1)),
                ("tiered depth 4", dict(store="tiered", prefetch_depth=4)),
                ("tiered memmap", dict(store="tiered",
                                       store_backend="memmap")),
                ("tiered sharded", dict(store="tiered",
                                        store_backend="sharded"))]
        for name, kw in variants:
            tr = _mlp_trainer(spec, data, scan_rounds=R, **kw)
            if not tr.scan_captured:
                raise AssertionError(f"tiered {tag} {name}: not captured")
            reset_launches()
            secs = _timed_chunks(tr, rounds, R)
            n = launches()
            runs[name] = (trainer_state(tr), _history(tr), n, secs,
                          tr.client_store_device_bytes())
            if n[key] != want_n or sum(n.values()) != want_n:
                raise AssertionError(f"tiered {tag} {name}: launches {n}, "
                                     f"want {key} {want_n}")
            if name != "dense":
                paths[path] += n[key]
            if name in ("dense", "tiered") and tag == "scaffold":
                trainers[name] = tr
            else:
                tr.close()
        ref_state, ref_hist = runs["dense"][0], runs["dense"][1]
        for name, (state, hist, n, secs, dev_bytes) in runs.items():
            apart = _apart(ref_state, state)
            log(f"tiered {tag}, {name}: s/round "
                + ", ".join(f"{v:.5f}" for v in secs)
                + f" (chunks of {R}; chunk 1 with warm-up and capture), "
                f"median of chunks 2-{len(secs)} "
                f"{statistics.median(secs[1:]):.5f}; client store on the "
                f"card {dev_bytes} B; {len(apart)} of {len(state)} leaves "
                f"apart from dense; history equal {hist == ref_hist}; "
                f"launches {n}")
            if apart or hist != ref_hist:
                raise AssertionError(f"tiered {tag} {name} vs dense: {apart}")
        row = runs["dense"][4] // spec.num_clients
        cap = min(spec.num_clients, R * spec.num_sampled)
        if (runs["tiered"][4], runs["dense"][4]) != (cap * row,
                                                     spec.num_clients * row):
            raise AssertionError(f"tiered {tag}: device bytes "
                                 f"{runs['tiered'][4]}, {runs['dense'][4]}")
        log(f"tiered {tag}: client_store_device_bytes tiered "
            f"{runs['tiered'][4]} = min(N, R S) {cap} x {row} B a row, "
            f"dense {runs['dense'][4]} = N {spec.num_clients} x {row}")
        result.setdefault("tiered_emnist", {})[tag] = {
            name: statistics.median(v[3][1:]) for name, v in runs.items()}
        if tag == "scaffold":
            for name, tr in trainers.items():
                share, card = _busy_share(tr)
                result.setdefault("tiered_busy", {})[name] = share
                log(f"tiered {tag}, {name}: card-busy share "
                    f"{100 * share:.1f}% (3 more chunks of {R}, each replay "
                    f"between CUDA events, over the chunk's wall), "
                    f"{card:.3f} ms of card time a round")
                tr.close()
            trainers.clear()
            ckpt = OUT / "tiered_ckpt"
            a = _mlp_trainer(spec, data, scan_rounds=R, store="tiered",
                             store_backend="memmap")
            a.run(7)
            save_trainer(str(ckpt), a)
            a.close()
            b = _mlp_trainer(spec, data, scan_rounds=R, store="tiered",
                             store_backend="memmap")
            load_trainer(str(ckpt) + ".npz", b)
            b.run(rounds - 7)
            apart = _apart(ref_state, trainer_state(b))
            hist_equal = _history(b) == ref_hist[7:]
            log(f"tiered {tag}: checkpoint after 7 rounds (memmap rows), "
                f"restored into a fresh trainer that ran rounds 8-{rounds}: "
                f"{len(apart)} leaves apart from the unbroken dense run, "
                f"history equal {hist_equal}")
            if apart or not hist_equal:
                raise AssertionError(f"tiered resume: {apart}")
            b.close()
            (OUT / "tiered_ckpt.npz").unlink()
    result.setdefault("b1_paths", {})["emnist tiered scanned"] = paths[
        "b1_paths"]
    result.setdefault("b2_paths", {})["emnist tiered scanned"] = paths[
        "b2_paths"]
    del data
    torch.cuda.empty_cache()


def _compare_population(tag, dense, tiered) -> None:
    """The dense scanned trainer's device store against a tiered store,
    ``POP_BLOCK`` rows at a time, and x and c: raises unless bitwise
    equal."""
    import numpy as np
    import torch

    apart = [k for k in dense.x if not torch.equal(dense.x[k],
                                                     tiered.x[k])]
    apart += [k for k in dense.c if not torch.equal(dense.c[k],
                                                      tiered.c[k])]
    tiered.sync_host_store()
    fams = dense._device_families()
    for name, st in tiered._store_families():
        for lo in range(0, st.num_clients, POP_BLOCK):
            ids = np.arange(lo, min(lo + POP_BLOCK, st.num_clients))
            got = st.gather(ids)
            for k, v in got.items():
                if not torch.equal(fams[name][k][lo:lo + len(ids)],
                                   v.to(fams[name][k].device)):
                    apart.append(f"{name}/{k} rows {lo}+")
    log(f"population {tag}: {len(apart)} leaves or blocks apart from the "
        f"dense engine")
    if apart:
        raise AssertionError(f"population {tag}: {apart[:8]}")


def phase_population(result):
    """Phase 27: population scale. ``benchmarks/bench_store.py``'s cohort
    (S 64, K 2, chunks of 16) on ``ProceduralQuadraticDataset`` at d 1024
    and N = 10^6: 4.1 GB of fp32 c_i against a cohort buffer of 1024 rows.
    SCAFFOLD with the K-step kernel, once B3 (sgd) and once B4 (local
    heavy-ball, a second 4.1 GB row family): the tiered engine over the
    dense and the memmap backends, then the dense scanned engine at the
    same N, 32 rounds each, all three bitwise equal (x, c and every
    row). Logs s/round, the client store on the card, the population's
    bytes, each trainer's peak device memory above what was held before
    it, the resident host memory its set-up and its rounds added, and the
    process's max RSS."""
    import tempfile

    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import ProceduralQuadraticDataset, quadratic_loss

    ds = ProceduralQuadraticDataset(POP_N, POP_DIM, seed=0)
    init = lambda gen: {"x": torch.ones(POP_DIM)}  # noqa: E731
    memmap_dir = OUT / "population_memmap"
    memmap_dir.mkdir(parents=True, exist_ok=True)
    for solver, key, path in (("sgd", "scaffold_local_loop", "b3_paths"),
                              ("momentum", "scaffold_momentum_local_loop",
                               "b4_paths")):
        spec = FedRoundSpec(algorithm="scaffold", num_clients=POP_N,
                            num_sampled=POP_S, local_steps=POP_K,
                            local_batch=1, eta_l=0.1, local_solver=solver,
                            local_momentum=0.9, use_megakernel=True)
        trainers = {}
        for name, kw in (("tiered dense", dict(store="tiered")),
                         ("tiered memmap", dict(store="tiered",
                                                store_backend="memmap")),
                         ("dense", {})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held, rss0 = torch.cuda.memory_allocated(), host_rss_gb()
            t0 = time.perf_counter()
            # the memmap backend's files under build/ (git-ignored)
            old_tmp, tempfile.tempdir = tempfile.tempdir, str(memmap_dir)
            try:
                tr = FederatedTrainer(quadratic_loss, init, spec, ds, seed=0,
                                      use_fused_update=True, device="cuda",
                                      scan_rounds=POP_CHUNK, **kw)
            finally:
                tempfile.tempdir = old_tmp
            setup = time.perf_counter() - t0
            rss1 = host_rss_gb()
            if not tr.scan_captured or tr.megakernel_fallback_reason != "":
                raise AssertionError(f"population {name}: captured "
                                     f"{tr.scan_captured}, megakernel "
                                     f"{tr.megakernel_fallback_reason!r}")
            reset_launches()
            secs = _timed_chunks(tr, POP_ROUNDS, POP_CHUNK)
            n = launches()
            want = POP_ROUNDS * POP_S
            losses = [m["loss"] for m in tr.history]
            pop = sum(st.population_nbytes for _, st in tr._store_families())
            rss2 = host_rss_gb()
            rec = dict(s_round=statistics.median(secs[1:]),
                       device_store_bytes=tr.client_store_device_bytes(),
                       population_bytes=pop,
                       peak_device_gb=(torch.cuda.max_memory_allocated()
                                       - held) / 1e9,
                       rss_added_gb=rss2 - rss0,
                       max_rss_gb=host_peak_gb())
            log(f"population {solver} ({key}), {name}: N {POP_N}, d "
                f"{POP_DIM}; set-up {setup:.2f} s; s/round "
                + ", ".join(f"{v:.5f}" for v in secs)
                + f" (chunks of {POP_CHUNK}; chunk 1 with warm-up and "
                f"capture); client store on the card "
                f"{rec['device_store_bytes']} B; population {pop} B in the "
                f"{name.split()[-1]} tier; peak device memory "
                f"{rec['peak_device_gb']:.3f} GB above the "
                f"{held / 1e9:.3f} GB held before; resident host memory "
                f"{rss1 - rss0:+.2f} GB by the set-up, {rss2 - rss1:+.2f} GB "
                f"by the rounds (max RSS {rec['max_rss_gb']:.1f} GB); loss "
                f"{losses[0]:.4f} -> "
                f"{losses[-1]:.4f}; launches {n}")
            if n[key] != want or sum(n.values()) != want or not all(
                    math.isfinite(v) for v in losses):
                raise AssertionError(f"population {name}: launches {n}, "
                                     f"want {key} {want}; losses {losses}")
            result.setdefault("population", {})[(solver, name)] = rec
            result.setdefault(path, {})[f"population {name}"] = n[key]
            trainers[name] = tr
        dense = trainers.pop("dense")
        for name, tr in trainers.items():
            _compare_population(f"{solver}, {name}", dense, tr)
            tr.close()
        dense.close()
        del dense, trainers, tr
        torch.cuda.empty_cache()


def phase_pipelined(result):
    """Phase 28: the pipelined host loop bitwise the synchronous one on
    the card. gemma3-1b at phase 10's settings (published widths, 26
    layers, seq 2048, N 4, S 2, K 2; B5 on the "W" layers, B1 on the
    steps), ``pipeline_depth`` 1 against 0, 3 rounds each; then Table 5's
    EMNIST (N 50, S 10, K 25, similarity 0) at depth 2 against 0, 10
    rounds, where clients come back in consecutive rounds, so prepared
    rows are repaired. x and every store row must be bitwise equal, the
    launches equal. Logs s/round of each depth and the rows repaired."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import controller
    from repro_torch.data import EmnistLikeFederated

    repaired = []
    real = controller.refresh_rows

    def counting(prefetched, fresh, stale):
        repaired.append(int(stale.sum()))
        real(prefetched, fresh, stale)

    seq_len, rounds = 2048, 3
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy="client_sequential")
    cfg, _, _ = _lm_fit(spec, seq_len, arch="gemma3-1b",
                        chunk=get_config("gemma3-1b").vocab_size // 16)
    n_w = cfg.pattern_for_layers().count("W")
    steps = spec.num_sampled * spec.local_steps
    controller.refresh_rows = counting
    try:
        runs = {}
        for depth in (0, 1):
            tr = _lm_trainer(cfg, spec, seq_len, pipeline_depth=depth)
            groups = len({v.dtype for v in tr.x.values()})
            reset_launches()
            del repaired[:]
            secs = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.run_round()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            _plan_vs_peak(f"pipelined gemma3-1b depth {depth}",
                          _lm_plan(cfg, seq_len, spec.local_batch)[2],
                          torch.cuda.max_memory_allocated())
            n = launches()
            want = _want_launches(swa_attention=n_w * steps * rounds,
                                  scaffold_update=steps * groups * rounds)
            runs[depth] = ({**{f"x/{k}": v.cpu() for k, v in tr.x.items()},
                            **{f"store/{k}": v for k, v in
                               tr.store.all_rows().items()}},
                           _history(tr), sum(repaired))
            log(f"pipelined gemma3-1b ({cfg.num_layers} layers, seq "
                f"{seq_len}), depth {depth}: s/round "
                + ", ".join(f"{v:.3f}" for v in secs)
                + f" (median of rounds 2-{rounds} "
                f"{statistics.median(secs[1:]):.3f}); rows repaired "
                f"{sum(repaired)}; peak host memory {host_peak_gb():.1f} GB;"
                f" launches {n}")
            if n != want:
                raise AssertionError(f"pipelined gemma depth {depth}: {n} "
                                     f"vs {want}")
            result.setdefault("pipelined", {})[("gemma3-1b", depth)] = \
                statistics.median(secs[1:])
            result.setdefault("b5_paths", {})[
                f"gemma3-1b pipelined depth {depth}"] = n["swa_attention"]
            result.setdefault("b1_paths", {})[
                f"gemma3-1b pipelined depth {depth}"] = n["scaffold_update"]
            tr.close()
            del tr
            torch.cuda.empty_cache()
        apart = _apart(runs[0][0], runs[1][0])
        log(f"pipelined gemma3-1b: depth 1 vs 0, {len(apart)} of "
            f"{len(runs[0][0])} leaves apart (x and store rows); history "
            f"equal {runs[0][1] == runs[1][1]}")
        if apart or runs[0][1] != runs[1][1]:
            raise AssertionError(f"pipelined gemma: {apart}")
        del runs

        data = EmnistLikeFederated(similarity_pct=0.0, **EMNIST)
        spec = FedRoundSpec(algorithm="scaffold",
                            local_batch=data.local_batch_size(0.2),
                            **EMNIST_SPEC)
        runs = {}
        log(f"reduced: pipelined table 5 rounds 10 -> "
            f"{PIPELINED_TABLE5_ROUNDS} (the script's time)")
        for depth in (0, 2):
            tr = _mlp_trainer(spec, data, pipeline_depth=depth)
            reset_launches()
            del repaired[:]
            secs = []
            for _ in range(PIPELINED_TABLE5_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.run_round()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            n = launches()
            want = _want_launches(scaffold_update=PIPELINED_TABLE5_ROUNDS
                                  * spec.num_sampled * spec.local_steps)
            runs[depth] = (trainer_state(tr), _history(tr))
            log(f"pipelined table 5 (N 50, S 10, K 25), depth {depth}: "
                f"s/round " + ", ".join(f"{v:.4f}" for v in secs)
                + f" (median of rounds 2-{PIPELINED_TABLE5_ROUNDS} "
                f"{statistics.median(secs[1:]):.4f})"
                f"; rows repaired {sum(repaired)} in "
                f"{len([r for r in repaired if r])} repairs; launches {n}")
            if n != want or (depth and not sum(repaired)):
                raise AssertionError(f"pipelined table 5 depth {depth}: {n} "
                                     f"vs {want}, repaired {repaired}")
            result.setdefault("pipelined", {})[("table 5", depth)] = \
                statistics.median(secs[1:])
            result.setdefault("b1_paths", {})[
                f"table 5 pipelined depth {depth}"] = n["scaffold_update"]
            tr.close()
        apart = _apart(runs[0][0], runs[2][0])
        log(f"pipelined table 5: depth 2 vs 0, {len(apart)} of "
            f"{len(runs[0][0])} leaves apart; history equal "
            f"{runs[0][1] == runs[2][1]}")
        if apart or runs[0][1] != runs[2][1]:
            raise AssertionError(f"pipelined table 5: {apart}")
    finally:
        controller.refresh_rows = real
    torch.cuda.empty_cache()

# the async buffered engine: its degenerate limit against the sync loop
# (phase 29), Table 5 under stragglers (phase 30), gemma3-1b through the
# entry point (phase 31)
SYNC_KEYS = ("loss", "drift", "update_norm", "bytes_up", "bytes_down",
             "round")
# the JAX package's async test's straggler model: lognormal latency, sigma
# 1.5, a dispatch dies with probability 0.2
STRAGGLER = dict(availability="lognormal",
                 availability_kwargs=dict(seed=1, sigma=1.5, dropout=0.2))
# (40 aggregations before a cut for the script's time)
ASYNC_AGGS, ASYNC_EVAL_EVERY, ASYNC_CHECK = 20, 10, 10
# Table 5's rounds on the pipelined loop (10 before the same cut)
PIPELINED_TABLE5_ROUNDS = 6
# phase 31's engine flags: M 2 of K 3 in flight, lognormal stragglers
ASYNC_GEMMA = ("--async-buffer", "2", "--max-inflight", "3",
               "--availability", "lognormal", "--latency-sigma", "1.0")


def _degenerate(tag, make, rounds, want, state=trainer_state):
    """Run ``make()`` (the sync host loop) and ``make(async_buffer=S,
    max_inflight=S)`` (always_on, constant) ``rounds`` rounds each, the
    launch counts set to 0 before each and read after: raises unless the
    two states (``state(tr)``), the sync keys of the histories and the
    launches are equal, and the launches are ``want`` (a dict of nonzero
    counts). Logs s/round of both. Returns the async run's launches and
    its trainer's peak device memory above what was held before it."""
    import torch

    runs = {}
    for name in ("sync", "async"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tr = make() if name == "sync" else make(
            async_buffer=make.num_sampled, max_inflight=make.num_sampled,
            availability="always_on", staleness_weighting="constant")
        if tr.async_active != (name == "async"):
            raise AssertionError(f"{tag}: async_active {tr.async_active}")
        reset_launches()
        secs = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        n = launches()
        peak = torch.cuda.max_memory_allocated() - held
        runs[name] = (state(tr), [{k: m[k] for k in SYNC_KEYS}
                                  for m in tr.history], n, peak)
        log(f"async degenerate {tag}, {name}: s/round "
            + ", ".join(f"{v:.4f}" for v in secs) + f"; peak device memory "
            f"{peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held; "
            f"launches {n}")
        tr.close()
        del tr
        torch.cuda.empty_cache()
    (a, ha, na, _), (b, hb, nb, peak) = runs["sync"], runs["async"]
    apart = _apart(a, b)
    log(f"async degenerate {tag}: {len(apart)} of {len(a)} leaves apart "
        f"from the sync loop (x, c, optimizer slots, every row family); "
        f"sync keys of the history equal {ha == hb}; launches equal "
        f"{na == nb}")
    if apart or ha != hb or na != nb or na != _want_launches(**want):
        raise AssertionError(f"async degenerate {tag}: apart {apart[:5]}, "
                             f"launches {na} / {nb}, want {want}")
    return nb, peak


def _maker(fn, num_sampled):
    """``fn`` as the trainer factory of :func:`_degenerate`."""
    fn.num_sampled = num_sampled
    return fn


def phase_async_degenerate(ds, result):
    """Phase 29: the async engine's degenerate limit (M = K = S,
    always_on, constant) bitwise the port's sync host loop on the card,
    with the same launches: Table 5's EMNIST MLP (N 50, S 10, K 25, batch
    80, eta_l 0.3, similarity 0), SCAFFOLD through B1, 5 aggregations;
    scaffold_m + int8_ef + server adam + local heavy-ball through B2, 3;
    phase 13's quadratics (d 1024, S 4, K 10, ``use_megakernel``) through
    B3 and, local heavy-ball, B4, 3; gemma3-1b at its published widths
    (26 layers, bf16, seq 2048, N 4, S 2, K 2, batch 1) through B5 and
    B1, 2, its peak device memory against ``_lm_plan`` with the pending
    updates."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import EmnistLikeFederated, quadratic_loss

    data = EmnistLikeFederated(similarity_pct=0.0, **EMNIST)
    lb = data.local_batch_size(0.2)
    for tag, change, key, path, rounds in (
            ("table 5 scaffold", dict(algorithm="scaffold"),
             "scaffold_update", "b1_paths", 5),
            ("table 5 scaffold_m int8_ef adam heavy-ball",
             dict(algorithm="scaffold_m", compress="int8_ef",
                  server_optimizer="adam", local_solver="momentum",
                  local_momentum=0.9), "scaffold_momentum_update",
             "b2_paths", 3)):
        spec = FedRoundSpec(local_batch=lb, **EMNIST_SPEC, **change)
        n, _ = _degenerate(tag, _maker(partial(_mlp_trainer, spec, data),
                                       spec.num_sampled), rounds,
                           {key: rounds * spec.num_sampled
                            * spec.local_steps})
        result.setdefault(path, {})[f"async degenerate {tag}"] = n[key]
    del data
    for tag, change, key, path in (
            ("quadratics B3", dict(algorithm="scaffold"),
             "scaffold_local_loop", "b3_paths"),
            ("quadratics B4", dict(algorithm="scaffold_m", eta_g=0.1,
                                   local_solver="momentum",
                                   local_momentum=0.9),
             "scaffold_momentum_local_loop", "b4_paths")):
        spec = FedRoundSpec(num_clients=20, num_sampled=4, local_steps=10,
                            local_batch=1, eta_l=0.1, use_megakernel=True,
                            **change)
        make = partial(FederatedTrainer, quadratic_loss,
                       lambda gen: {"x": torch.ones(ds.dim)}, spec, ds,
                       seed=0, use_fused_update=True, device="cuda")
        n, _ = _degenerate(tag, _maker(make, spec.num_sampled), 3,
                           {key: 3 * spec.num_sampled})
        result.setdefault(path, {})[f"async degenerate {tag}"] = n[key]

    seq_len, rounds = 2048, 2
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01)
    cfg, _, tree = _lm_fit(spec, seq_len, arch="gemma3-1b",
                           chunk=get_config("gemma3-1b").vocab_size // 16)
    if cfg.num_layers != get_config("gemma3-1b").num_layers:
        raise AssertionError(f"async gemma: depth cut to {cfg.num_layers}")
    n_w = cfg.pattern_for_layers().count("W")
    steps = spec.num_sampled * spec.local_steps
    pending = 2 * spec.num_sampled - 1
    _, _, plan = _lm_plan(cfg, seq_len, 1, pending=pending)

    def lm_state(tr):
        # x, c on the host; the dense store's own rows (not copied)
        return {**{f"x/{k}": v.cpu() for k, v in tr.x.items()},
                **{f"c/{k}": v.cpu() for k, v in tr.c.items()},
                **{f"c_i/{k}": v for k, v in tr.store.all_rows().items()}}

    n, peak = _degenerate(
        "gemma3-1b", _maker(partial(_lm_trainer, cfg, spec, seq_len),
                            spec.num_sampled), rounds,
        {"swa_attention": n_w * steps * rounds,
         "scaffold_update": steps * rounds}, state=lm_state)
    log(f"async degenerate gemma3-1b: peak device memory {peak / 1e9:.2f} GB"
        f" above what was held, the plan {plan / 1e9:.2f} GB (8 bf16 trees, "
        f"the fp32 dy and dc sums, {pending} pending updates' dy and dc at "
        f"{tree / 1e9:.2f} GB a tree, activations and temporaries)")
    result.setdefault("async", {})["gemma degenerate peak"] = (peak, plan)
    result.setdefault("b5_paths", {})["async degenerate gemma3-1b"] = n[
        "swa_attention"]
    result.setdefault("b1_paths", {})["async degenerate gemma3-1b"] = n[
        "scaffold_update"]


def _sync_virtual_time(model, num_clients, num_sampled, rounds, seed):
    """The sync baseline's virtual duration under ``model``: a round
    waits for its cohort's slowest client (``benchmarks/bench_async.py``'s
    ``_sync_virtual_time``: dropout excluded, the sync loop re-waits),
    the cohorts drawn as the sync trainer's sampler draws them."""
    import numpy as np

    total, k = 0.0, {}
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        cohort = rng.choice(num_clients, size=num_sampled, replace=False)
        total += max(model.fate(int(c), k.setdefault(int(c), 0))[0]
                     for c in cohort)
        for c in cohort:
            k[int(c)] += 1
    return total


def phase_async_stragglers(result):
    """Phase 30: Table 5's EMNIST MLP (N 50, S 10, K 25, batch 80, eta_l
    0.3, similarity 0) through the async engine and B1 under stragglers:
    lognormal latency (sigma 1.5) with 20 % dropout, M 5 of K 10 in
    flight, polynomial weighting (alpha 0.5), 40 aggregations. Logs the
    best test accuracy every 10 aggregations, s/aggregation, the summed
    staleness histogram, the dropped updates, the virtual time against
    the sync loop's under the same latency model, and the card-busy share
    of a profiled aggregation. The tiered store over the dense and memmap
    backends, and a checkpoint taken after 5 aggregations with updates in
    flight and buffered, then resumed in a fresh trainer, must equal the
    dense run's first 10 aggregations bitwise."""
    import torch

    from repro_torch.checkpoint import load_trainer, save_trainer
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import make_availability
    from repro_torch.data import EmnistLikeFederated
    from repro_torch.models import simple

    data = EmnistLikeFederated(similarity_pct=0.0, **EMNIST)
    tb = data.test_batch(device="cuda")
    spec = FedRoundSpec(algorithm="scaffold",
                        local_batch=data.local_batch_size(0.2), **EMNIST_SPEC)
    kw = dict(async_buffer=5, max_inflight=10, staleness_weighting="polynomial",
              staleness_kwargs=dict(alpha=0.5), **STRAGGLER)
    tr = _mlp_trainer(spec, data, **kw)
    reset_launches()
    secs, accs, snap = [], [], None
    for a in range(ASYNC_AGGS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"async stragglers: aggregation {a + 1} {m}")
        if a + 1 == ASYNC_CHECK:
            snap = (trainer_state(tr), _history(tr))
        if (a + 1) % ASYNC_EVAL_EVERY == 0:
            accs.append(simple.accuracy(simple.mlp_logits, tr.x, tb))
    n = launches()
    dispatched = sum(h["dispatched"] for h in tr.history)
    want = _want_launches(scaffold_update=dispatched * spec.local_steps)
    hist = [0] * max(len(h["staleness_hist"]) for h in tr.history)
    for h in tr.history:
        for tau, c in enumerate(h["staleness_hist"]):
            hist[tau] += c
    sim_time = tr.history[-1]["sim_time"]
    model = make_availability("lognormal", seed=1, sigma=1.5)
    sync_time = _sync_virtual_time(model, spec.num_clients,
                                   spec.num_sampled, ASYNC_AGGS, seed=0)
    rec = dict(s_agg=statistics.median(secs[1:]), best=max(accs),
               hist=hist, dropped=tr.async_engine.dropped_total,
               dispatched=dispatched,
               sim_rounds_per_s=ASYNC_AGGS / sim_time,
               sync_rounds_per_s=ASYNC_AGGS / sync_time)
    log(f"async stragglers (table 5 MLP, N 50, M 5 of K 10, lognormal sigma "
        f"1.5, dropout 0.2, polynomial 0.5): best test accuracy "
        f"{rec['best']:.4f} (every {ASYNC_EVAL_EVERY} aggregations: "
        + ", ".join(f"{v:.3f}" for v in accs)
        + f"); s/aggregation median of 2-{ASYNC_AGGS} {rec['s_agg']:.4f} "
        f"(first {secs[0]:.3f}); {dispatched} dispatched, "
        f"{rec['dropped']} dropped; staleness histogram {hist} (sum "
        f"{sum(hist)} = {ASYNC_AGGS} x M 5); virtual time {sim_time:.3f}: "
        f"{rec['sim_rounds_per_s']:.4f} aggregations a virtual second, the "
        f"sync loop {sync_time:.3f} for {ASYNC_AGGS} rounds of S 10 under "
        f"the same latencies ({rec['sync_rounds_per_s']:.4f} rounds a "
        f"virtual second); launches {n}")
    if (n != want or sum(hist) != ASYNC_AGGS * 5 or not rec["dropped"]
            or not max(accs) > 0.10):
        raise AssertionError(f"async stragglers: launches {n} vs {want}, "
                             f"hist {hist}, accuracies {accs}")
    result.setdefault("b1_paths", {})["async stragglers"] = n[
        "scaffold_update"]
    rec["busy"] = _profile_round(
        tr, "async_stragglers", kernels=("scaffold_update",),
        want=lambda made: {"scaffold_update_kernel":
                           made["scaffold_update"]}, tries=3)
    result.setdefault("async", {})["stragglers"] = rec
    tr.close()
    del tr

    ref_state, ref_hist = snap
    checks = {}
    for name, extra in (("tiered dense", dict(store="tiered")),
                        ("tiered memmap", dict(store="tiered",
                                               store_backend="memmap"))):
        t = _mlp_trainer(spec, data, **kw, **extra)
        reset_launches()
        t.run(ASYNC_CHECK)
        n = launches()
        checks[name] = (_apart(ref_state, trainer_state(t)),
                        _history(t) == ref_hist)
        result["b1_paths"][f"async stragglers {name}"] = n["scaffold_update"]
        t.close()
    ckpt = OUT / "async_ckpt"
    part = _mlp_trainer(spec, data, **kw)
    part.run(ASYNC_CHECK // 2)
    eng = part.async_engine
    while not eng._buffer:
        if eng.step() is not None:
            raise AssertionError("async stragglers: an aggregation fired "
                                 "before an update was buffered")
    pending = (len(eng._inflight), len(eng._buffer))
    save_trainer(str(ckpt), part)
    part.close()
    resumed = _mlp_trainer(spec, data, **kw)
    load_trainer(str(ckpt) + ".npz", resumed)
    resumed.run(ASYNC_CHECK - ASYNC_CHECK // 2)
    checks["resumed"] = (_apart(ref_state, trainer_state(resumed)),
                         _history(resumed) == ref_hist[ASYNC_CHECK // 2:])
    resumed.close()
    (OUT / "async_ckpt.npz").unlink()
    for name, (apart, same) in checks.items():
        log(f"async stragglers, {name}: {len(apart)} of {len(ref_state)} "
            f"leaves apart from the dense run after {ASYNC_CHECK} "
            f"aggregations; history equal {same}"
            + (f" (checkpoint after {ASYNC_CHECK // 2} aggregations and "
               f"the steps to a buffered update: {pending[0]} in flight, "
               f"{pending[1]} buffered)" if name == "resumed" else ""))
        if apart or not same:
            raise AssertionError(f"async stragglers {name}: {apart[:5]}")
    del data, tb
    torch.cuda.empty_cache()


def phase_async_gemma(result):
    """Phase 31: gemma3-1b at its published widths (26 layers, seq 2048,
    N 4, S 2, K 2, batch 1) through ``repro_torch.launch.train.main`` with
    ``--async-buffer 2 --max-inflight 3 --availability lognormal
    --latency-sigma 1.0``: full space, 3 aggregations (B5 on every "W"
    layer, B1 on every local step), s/aggregation and peak device memory
    against ``_lm_plan`` with the pending updates. Then LoRA r 8 with the
    same flags: 2 aggregations and a checkpoint with updates in flight,
    the same trainer's third aggregation (the unbroken run), and a fresh
    process that resumes from the checkpoint and runs aggregation 3,
    bitwise equal to it."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    base = get_config("gemma3-1b")
    seq_len, chunk = 2048, base.vocab_size // 16
    cfg = dataclasses.replace(base, loss_chunk_vocab=chunk)
    n_w, K, M, inflight = cfg.pattern_for_layers().count("W"), 2, 2, 3
    _, tree, plan = _lm_plan(cfg, seq_len, 1, pending=M + inflight - 1)

    def run(tag, rounds, *extra, after=None, plan=0):
        reset_launches()
        t0 = time.perf_counter()
        with _RoundLog(f"async gemma, {tag}", M * K * seq_len, plan) as rl:
            tr = train.main(_train_argv("gemma3-1b", seq_len, rounds, chunk,
                                        *ASYNC_GEMMA, *extra))
            if after is not None:
                after(tr)
        counts = launches()
        dispatched = sum(h["dispatched"] for h in tr.history)
        # every dispatch runs its K steps when dispatched; the entry
        # point's eval after each of its rounds runs the W layers once
        want = _want_launches(
            swa_attention=n_w * (K * dispatched + rounds),
            scaffold_update=K * dispatched)
        log(f"async gemma, {tag}: train.main {time.perf_counter() - t0:.1f} s"
            f" in all; {dispatched} dispatches, dropped "
            f"{tr.async_engine.dropped_total}, staleness "
            f"{[h['staleness_hist'] for h in tr.history]}; launches "
            f"{counts}; want swa_attention = {n_w} W layers x (K {K} x "
            f"dispatches + {rounds} evals), scaffold_update = K x dispatches")
        if counts != want or not tr.async_active:
            raise AssertionError(f"async gemma {tag}: launches {counts} vs "
                                 f"{want}")
        for key, path in (("swa_attention", "b5_paths"),
                          ("scaffold_update", "b1_paths")):
            paths = result.setdefault(path, {})
            paths["async gemma3-1b"] = (paths.get("async gemma3-1b", 0)
                                        + counts[key])
        return tr, rl.rows

    tr, rows = run("full space, 3 aggregations", 3)
    peak = max(r["peak_bytes"] for r in rows)
    secs = [r["seconds"] for r in rows]
    log(f"async gemma, full space: s/aggregation "
        + ", ".join(f"{v:.3f}" for v in secs) + f"; peak device memory "
        f"{peak / 1e9:.2f} GB against the plan {plan / 1e9:.2f} GB ("
        f"{M + inflight - 1} pending updates' dy and dc at {tree / 1e9:.2f} "
        f"GB a tree); client_store_device_bytes (the reference's reckoning, "
        f"(K + M) rows) {tr.client_store_device_bytes() / 1e9:.2f} GB")
    result.setdefault("async", {})["gemma"] = dict(
        s_agg=statistics.median(secs[1:]), peak=peak, plan=plan)
    tr.close()
    del tr
    torch.cuda.empty_cache()

    lora = ("--update-space", "lora", "--lora-rank", str(LORA_RANK))
    ckpt, ckpt3 = OUT / "async_lora_ckpt", OUT / "async_lora_resumed"
    unbroken = {}

    def third(tr):
        eng = tr.async_engine
        unbroken["pending"] = (len(eng._inflight), len(eng._buffer))
        tr.run_round()  # the unbroken run's aggregation 3
        unbroken.update({f"x/{k}": v.cpu() for k, v in tr.x.items()})
        unbroken.update({f"c/{k}": v.cpu() for k, v in tr.c.items()})

    n_t, n_delta = _space_sizes(cfg, "lora", LORA_RANK)
    lora_plan = _lm_plan(cfg, seq_len, 1, subset=(n_t, 4 * n_delta),
                         pending=M + inflight - 1)[2]
    tr, rows = run("lora, 2 aggregations, --checkpoint, aggregation 3", 2,
                   *lora, "--checkpoint", str(ckpt), after=third,
                   plan=lora_plan)
    pending = unbroken.pop("pending")
    tr.close()
    del tr
    torch.cuda.empty_cache()
    if not pending[0]:
        raise AssertionError(f"async gemma lora: nothing in flight at the "
                             f"checkpoint ({pending})")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_train_argv("gemma3-1b", seq_len, 1, chunk, *ASYNC_GEMMA, *lora,
                      "--resume", str(ckpt) + ".npz", "--checkpoint",
                      str(ckpt3))],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=900)
    log(f"async gemma lora: a fresh process resumed and ran aggregation 3 "
        f"in {time.perf_counter() - t0:.1f} s (exit {proc.returncode}): "
        + " | ".join(proc.stdout.strip().splitlines()[-4:]))
    if proc.returncode:
        raise AssertionError(f"async gemma lora resume: {proc.stderr[-2000:]}")
    with np.load(str(ckpt3) + ".npz") as data:
        resumed = {k: data[k] for k in unbroken}
    apart = [k for k, v in unbroken.items()
             if not np.array_equal(resumed[k].view(np.uint8),
                                   v.numpy().view(np.uint8))]
    log(f"async gemma lora: checkpoint after 2 aggregations with "
        f"{pending[0]} in flight and {pending[1]} buffered; the resumed "
        f"process's aggregation 3 has {len(apart)} of {len(unbroken)} x and c"
        f" leaves apart from the unbroken run's (want 0, bitwise)")
    if apart:
        raise AssertionError(f"async gemma lora resume: apart {apart[:5]}")
    for path in (ckpt, ckpt3):
        Path(str(path) + ".npz").unlink()


SSM_CHUNK = 16384  # the SSM phases' CE vocab chunk (hymba: 2, mamba2: 4)
HYMBA_LORA_ELEMENTS = 8_077_312
# the sequence lengths phase_mamba2_full tries, longest first: the first
# whose plan fits LM_MEMORY_LIMIT runs (sequence is cut, not depth)
MAMBA2_SEQS = (2048, 1024, 512)


def phase_ssm_small():
    """Phase 32: the reduced fp32 mamba2 ("MM", chunk 32) at seq 64 and
    the reduced hymba ("YY", window 64) at seq 128, one SCAFFOLD round
    each on the card vs the CPU: hymba's attention takes the band path,
    B5 on the card."""
    for arch, seq, n_swa in (("mamba2-2.7b", 64, 0), ("hymba-1.5b", 128, 2)):
        err, counts, steps = _card_vs_cpu_round(arch, seq)
        want = {k: 0 for k in counts["cuda"]}
        want.update(swa_attention=n_swa * steps, scaffold_update=steps)
        log(f"ssm check: 2-layer fp32 {arch} at seq {seq}, one SCAFFOLD round"
            f" on the card (kernels) vs the CPU (plain): max leaf rel err "
            f"{err:.2e} (bound 1e-4); card launches {counts['cuda']} (want "
            f"swa_attention {want['swa_attention']}, scaffold_update {steps})")
        if not err <= 1e-4:
            raise AssertionError(f"ssm check {arch}: rel err {err}")
        if counts["cuda"] != want or any(counts["cpu"].values()):
            raise AssertionError(f"ssm check {arch}: launches {counts}")


def _lm_rounds(tag, cfg, spec, seq_len, rounds, plan):
    """``rounds`` SCAFFOLD rounds of ``cfg`` on the card from a fresh
    trainer, each logged with its seconds, tokens/s and peak device
    memory beside the plan; returns the trainer, its launches and the
    rounds' seconds and peaks."""
    import torch

    t0 = time.perf_counter()
    tr = _lm_trainer(cfg, spec, seq_len)
    torch.cuda.synchronize()
    log(f"{tag}: trainer set-up {time.perf_counter() - t0:.1f} s (init on "
        f"the card, host store of {tr.store.population_nbytes / 1e9:.1f} GB);"
        f" x in {len(tr.x)} leaves: " + ", ".join(
            f"{sum(v.numel() for v in tr.x.values() if v.dtype == dt)} "
            f"{str(dt).split('.')[-1]}"
            for dt in sorted({v.dtype for v in tr.x.values()}, key=str)))
    tokens = spec.num_sampled * spec.local_steps * spec.local_batch * seq_len
    secs, peaks = [], []
    reset_launches()
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        log(f"{tag} round {r + 1}: loss {m['loss']:.4f}, drift "
            f"{m['drift']:.4e}, {secs[-1]:.3f} s, {tokens / secs[-1]:.1f} "
            f"tokens/s ({tokens} tokens), peak device memory "
            f"{peaks[-1] / 1e9:.2f} GB (planned {plan / 1e9:.2f} GB), peak "
            f"host memory {host_peak_gb():.1f} GB")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
            raise AssertionError(f"{tag} round {r + 1}: non-finite {m}")
    return tr, launches(), secs, peaks


def _lm_spec():
    from repro_torch.configs.base import FedRoundSpec

    return FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy="client_sequential")


def phase_hymba_full(result):
    """Phase 33: hymba-1.5b at its published widths and all 32 "Y" layers
    in bf16, seq 2048: every layer's attention forward through B5 (25q/5kv
    x 64, window 1024) beside its Mamba2 block; the local steps through
    B1 on the two dtype groups (the bf16 weights; the fp32 ``a_log``,
    ``dt_bias`` and ``d_skip``); launch counts held exactly, round times,
    memory against the plan, a profiled round, B1 timed on the mixed
    tree. Then LoRA r 8 on the default targets through
    ``repro_torch.launch.train.main --arch hymba-1.5b --preset full``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    seq_len, rounds = 2048, 3
    spec = _lm_spec()
    cfg, _, _ = _lm_fit(spec, seq_len, arch="hymba-1.5b", chunk=SSM_CHUNK)
    if cfg.num_layers != get_config("hymba-1.5b").num_layers:
        raise AssertionError(f"hymba: the memory plan cut depth to "
                             f"{cfg.num_layers} layers")
    plan = _lm_plan(cfg, seq_len, spec.local_batch)[2]
    tr, counts, secs, peaks = _lm_rounds("hymba", cfg, spec, seq_len,
                                          rounds, plan)
    groups = len(_b1_groups(tr))
    steps = spec.num_sampled * spec.local_steps
    want = {k: 0 for k in counts}
    want.update(swa_attention=cfg.num_layers * steps * rounds,
                scaffold_update=steps * groups * rounds)
    log(f"hymba: launches {counts}; want swa_attention = {cfg.num_layers} Y "
        f"layers x S {spec.num_sampled} x K {spec.local_steps} x rounds "
        f"{rounds} = {want['swa_attention']}, scaffold_update = S x K x "
        f"groups {groups} x rounds = {want['scaffold_update']}, nothing "
        f"else; rounds 2-{rounds} mean {statistics.mean(secs[1:]):.3f} s, "
        f"peak {max(peaks) / 1e9:.2f} GB against the plan's "
        f"{plan / 1e9:.2f} GB")
    if groups != 2 or counts != want or want["swa_attention"] != 384 or \
            want["scaffold_update"] != 24:
        raise AssertionError(f"hymba: {groups} groups, launches {counts} != "
                             f"{want}")
    result.setdefault("b5_paths", {})["hymba-1.5b"] = counts["swa_attention"]
    result.setdefault("b1_paths", {})["hymba-1.5b"] = counts[
        "scaffold_update"]
    log("reduced: hymba, no profiled round (the script's time; its busy "
        "share is in PERF.md from earlier runs)")
    result["b1"].setdefault("trees", {})["hymba mixed"] = _time_update_tree(
        "scaffold_update at the hymba-1.5b tree (bf16 and fp32 groups)",
        tr.x, tr.c, spec.eta_l)
    tr.close()
    del tr
    torch.cuda.empty_cache()

    # LoRA r 8 on the default targets through the entry point: B5 on every
    # layer in the steps and the eval after each round, B1 on the delta
    # tree's one fp32 group
    lora_rounds = 2
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              loss_chunk_vocab=SSM_CHUNK)
    elements, plan = _subset_plan("lora hymba", cfg, seq_len,
                                  "lora", LORA_RANK)
    reset_launches()
    with _RoundLog("lora hymba", steps * seq_len, plan) as rl:
        tr = train.main(_train_argv(
            "hymba-1.5b", seq_len, lora_rounds, SSM_CHUNK, "--update-space",
            "lora", "--lora-rank", str(LORA_RANK)))
    counts = launches()
    want = {k: 0 for k in counts}
    want.update(swa_attention=cfg.num_layers * (steps + 1) * lora_rounds,
                scaffold_update=steps * lora_rounds)
    secs = ", ".join(f"{r['seconds']:.3f}" for r in rl.rows)
    log(f"lora hymba: launches {counts}; want swa_attention = "
        f"{cfg.num_layers} x (S x K {steps} + 1 eval) x rounds "
        f"{lora_rounds} = {want['swa_attention']}, scaffold_update = "
        f"{want['scaffold_update']}; s/round {secs}")
    if (elements != HYMBA_LORA_ELEMENTS or len(tr.x) != 14
            or counts != want):
        raise AssertionError(f"lora hymba: delta tree {elements}, "
                             f"{len(tr.x)} leaves, launches {counts}")
    _check_subset_rounds("lora hymba", tr, rl.rows, "lora", elements, 4)
    result["b5_paths"]["lora hymba-1.5b"] = counts["swa_attention"]
    result["b1_paths"]["lora hymba-1.5b"] = counts["scaffold_update"]
    tr.close()
    del tr
    torch.cuda.empty_cache()


def _b1_groups(tr) -> dict:
    """B1's dtype groups of trainer ``tr``'s x (y, g and c share x's
    dtypes leaf by leaf)."""
    from repro_torch.kernels.scaffold_update import ops

    return ops.dtype_groups(tr.x, tr.x, tr.c)


def phase_mamba2_full(result):
    """Phase 34: mamba2-2.7b at its published widths and all 64 "M"
    layers in bf16, at the longest of ``MAMBA2_SEQS`` whose plan fits
    (sequence cut, not depth): SCAFFOLD through B1 on its two dtype groups
    (no attention, no B5); launch counts held exactly, round times,
    memory against the plan, a profiled round."""
    import torch

    from repro_torch.configs import get_config

    spec, rounds = _lm_spec(), 2
    log("reduced: mamba2 rounds 3 -> 2 (the script's time)")
    base = dataclasses.replace(get_config("mamba2-2.7b"),
                               loss_chunk_vocab=SSM_CHUNK)
    for seq_len in MAMBA2_SEQS:
        plan = _lm_plan(base, seq_len, spec.local_batch)[2]
        log(f"mamba2: plan at seq {seq_len}, 64 layers: {plan / 1e9:.1f} GB "
            f"(limit {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
        if plan <= LM_MEMORY_LIMIT:
            break
    if seq_len != MAMBA2_SEQS[0]:
        log(f"reduced: seq {MAMBA2_SEQS[0]} -> {seq_len} (mamba2-2.7b, depth "
            f"kept at {base.num_layers})")
    cfg, _, _ = _lm_fit(spec, seq_len, arch="mamba2-2.7b", chunk=SSM_CHUNK)
    if cfg.num_layers != base.num_layers:
        raise AssertionError(f"mamba2: the memory plan cut depth to "
                             f"{cfg.num_layers} layers at seq {seq_len}")
    tr, counts, secs, peaks = _lm_rounds("mamba2", cfg, spec, seq_len,
                                          rounds, plan)
    groups = len(_b1_groups(tr))
    steps = spec.num_sampled * spec.local_steps
    want = {k: 0 for k in counts}
    want.update(scaffold_update=steps * groups * rounds)
    log(f"mamba2: launches {counts}; want scaffold_update = S x K {steps} x "
        f"groups {groups} x rounds {rounds} = {want['scaffold_update']}, "
        f"nothing else; rounds 2-{rounds} mean "
        f"{statistics.mean(secs[1:]):.3f} s, peak {max(peaks) / 1e9:.2f} GB "
        f"against the plan's {plan / 1e9:.2f} GB at seq {seq_len}")
    if groups != 2 or counts != want or want["scaffold_update"] != 16:
        raise AssertionError(f"mamba2: {groups} groups, launches {counts} "
                             f"!= {want}")
    result.setdefault("b1_paths", {})["mamba2-2.7b"] = counts[
        "scaffold_update"]
    log("reduced: mamba2, no profiled round (the script's time; its busy "
        "share is in PERF.md from earlier runs)")
    tr.close()
    del tr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# untied embeddings, the prefix LM, long "F" sequences, the encoder-decoder
# ---------------------------------------------------------------------------

# the CE vocab chunks of minitron-4b (16 chunks of its 256000) and
# paligemma-3b (16 of its 257216)
MINITRON_CHUNK, PALIGEMMA_CHUNK = 16000, 16076
MINITRON_HEAD = "unembed*,ln_final*"
# flash_attention card vs CPU: (B, S, Hq, Hkv, D, mask): S 3072 is three
# kv blocks of 1024; gemma3-1b's "F" layer (4q/1kv x 256) and GQA n_rep 2
FLASH_CASES = ((1, 3072, 4, 1, 256, "causal"), (1, 3072, 4, 2, 64, "prefix"),
               (2, 3072, 4, 2, 64, "full"))


def _fed_batch(cfg, spec, text_len, gen):
    """One round's batch of ``cfg`` on the card, leaves (S, K, b, ...):
    tokens and next-token labels drawn uniformly, and the stub
    frontends' ``patches`` (prefix LM) or ``frames`` (encoder-decoder)
    as normals in the compute dtype, from the card generator ``gen``."""
    import torch

    from repro_torch.models.model import _dtype

    lead = (spec.num_sampled, spec.local_steps, spec.local_batch)
    toks = torch.randint(0, cfg.vocab_size, lead + (text_len + 1,),
                         generator=gen, device=gen.device)
    batch = {"tokens": toks[..., :-1].contiguous(),
             "labels": toks[..., 1:].contiguous()}
    dt = _dtype(cfg.compute_dtype)
    if cfg.num_prefix_tokens:
        batch["patches"] = torch.randn(
            lead + (cfg.num_prefix_tokens, cfg.d_model), generator=gen,
            device=gen.device).to(dt)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn(
            lead + (cfg.encoder.num_frames, cfg.d_model), generator=gen,
            device=gen.device).to(dt)
    return batch


def _fed_state(cfg, spec, x):
    """c (zeros on x's device) and the S sampled clients' c_i rows (zeros
    on the host: ``run_round`` moves a client's rows to the card only
    while it runs)."""
    import torch

    c = {k: torch.zeros_like(v) for k, v in x.items()}
    c_i = {k: torch.zeros((spec.num_sampled,) + tuple(v.shape),
                          dtype=v.dtype) for k, v in x.items()}
    return c, c_i


def _card_vs_cpu_fed_round(arch: str, text_len: int):
    """One SCAFFOLD ``federated_round`` of ``arch``'s reduced fp32 config
    on the card (B1) and on the CPU (plain) from the same weights, c,
    c_i and batch (drawn on the CPU); returns the max leaf error of x, c
    and c_i, each side's launch counts and the round's local steps. A
    leaf's error is relative to its largest element. A c or c_i leaf,
    Option II's ``(x - y_K) / (K eta_l)`` less c, has an absolute floor
    of 16 fp32 eps of x's largest element over ``K eta_l``, so the error
    is relative to the larger of its largest element and that floor over
    the bound 1e-4: a step's rounding of y is an ulp of x, and the
    difference divides it by ``K eta_l``."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import federated_round, make_grad_fn
    from repro_torch.models import model as M

    cfg = get_reduced(arch)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.05)
    gen = torch.Generator().manual_seed(0)
    x0 = M.init_params(cfg, gen, device="cpu")
    c0 = {k: 0.01 * torch.randn(v.shape, generator=gen)
          for k, v in x0.items()}
    ci0 = {k: 0.01 * torch.randn((2,) + tuple(v.shape), generator=gen)
           for k, v in x0.items()}
    batch0 = _fed_batch(cfg, spec, text_len, gen)
    grad_fn = make_grad_fn(partial(M.loss_fn, cfg))
    outs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        x = {k: v.to(dev) for k, v in x0.items()}
        c = {k: v.to(dev) for k, v in c0.items()}
        batch = {k: v.to(dev) for k, v in batch0.items()}
        reset_launches()
        got = federated_round(grad_fn, spec, x, c,
                              {k: v.clone() for k, v in ci0.items()}, batch,
                              use_fused_update=True)
        counts[dev] = launches()
        outs[dev] = [{k: v.cpu() for k, v in t.items()} for t in got[:3]]
    k_eta = spec.local_steps * spec.eta_l
    err, worst = 0.0, ""
    eps = torch.finfo(torch.float32).eps
    for k, x in outs["cpu"][0].items():
        floor = 16 * eps * float(x.abs().max()) / k_eta / 1e-4
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            scale = max(float(b[k].abs().max()), floor if i else 0.0, 1e-30)
            e = float((a[k].double() - b[k].double()).abs().max()) / scale
            if e > err:
                err, worst = e, f"{('x', 'c', 'c_i')[i]} {k}"
    log(f"new check {arch}: the worst leaf is {worst} ({err:.2e})")
    return err, counts, spec.num_sampled * spec.local_steps


def _check_flash_attention(result) -> None:
    """``layers.flash_attention`` on the card (plain PyTorch: the
    reference has no kernel here) against the same call on the CPU at
    S 3072 (three kv blocks), fp32, each mask: within 1e-5 of the
    output's largest element; no kernel of the port launches."""
    import torch

    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(11)
    for b, s, hq, hkv, d, mask in FLASH_CASES:
        q = torch.randn((b, s, hq, d), generator=gen)
        k, v = (torch.randn((b, s, hkv, d), generator=gen) for _ in range(2))
        want = L.flash_attention(q, k, v, mask_kind=mask, prefix_len=256)
        reset_launches()
        got = L.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                mask_kind=mask, prefix_len=256)
        torch.cuda.synchronize()
        err = rel_err(got.cpu(), want)
        log(f"flash check: flash_attention (B {b}, S {s}, {hq}q/{hkv}kv x "
            f"{d}, {mask}) on the card vs the CPU: rel err {err:.2e} "
            f"(bound 1e-5); launches {launches()}")
        if not err <= 1e-5 or any(launches().values()):
            raise AssertionError(f"flash check {mask}: rel err {err}")
        result.setdefault("flash", {})[f"{mask} S {s}"] = err


def phase_new_small(result):
    """Phase 35: the reduced fp32 minitron (untied, through the trainer),
    paligemma (16 patches, prefix mask) and whisper (2 + 2 layers over
    64 frames), one SCAFFOLD round each on the card vs the CPU, the
    latter two through ``federated_round`` with their stub inputs;
    ``flash_attention`` on the card vs the CPU at S 3072."""
    err, counts, steps = _card_vs_cpu_round("minitron-4b", 32)
    checks = [("minitron-4b", err, counts, steps)]
    for arch in ("paligemma-3b", "whisper-tiny"):
        checks.append((arch, *_card_vs_cpu_fed_round(arch, 32)))
    for arch, err, counts, steps in checks:
        want = {k: 0 for k in counts["cuda"]}
        want.update(scaffold_update=steps)
        log(f"new check: 2-layer fp32 {arch}, one SCAFFOLD round on the card"
            f" (B1) vs the CPU (plain): max leaf err {err:.2e} (bound 1e-4;"
            f" relative, c and c_i with a floor of 16 eps x over K eta_l);"
            f" card "
            f"launches {counts['cuda']} (want scaffold_update {steps}, "
            f"nothing else)")
        if not err <= 1e-4:
            raise AssertionError(f"new check {arch}: rel err {err}")
        if counts["cuda"] != want or any(counts["cpu"].values()):
            raise AssertionError(f"new check {arch}: launches {counts}")
        result.setdefault("b1_paths", {})[f"{arch} card vs CPU"] = steps
    _check_flash_attention(result)


def _fed_rounds(tag, cfg, spec, text_len, rounds, plan, result):
    """``rounds`` SCAFFOLD rounds of ``cfg`` through ``federated_round`` on
    the card (x, c and the batches there, the c_i rows on the host), each
    batch drawn on the card from a seeded generator; each round logged
    with its seconds, tokens/s and peak device memory beside the plan;
    then B1 held to its plain version and timed on the trained x and c
    (``result['b1']['trees'][tag]``). Returns the launches, the rounds'
    seconds and peaks, and the first and last rounds' losses."""
    import torch

    from repro_torch.core import federated_round, make_grad_fn
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = M.init_params(cfg, gen, device="cuda")
    c, c_i = _fed_state(cfg, spec, x)
    grad_fn = make_grad_fn(partial(M.loss_fn, cfg))
    torch.cuda.synchronize()
    log(f"{tag}: set-up {time.perf_counter() - t0:.1f} s (init on the card, "
        f"c_i rows of {sum(v.nbytes for v in c_i.values()) / 1e9:.2f} GB on "
        f"the host); x in {len(x)} leaves, "
        f"{sum(v.numel() for v in x.values())} "
        f"{str(next(iter(x.values())).dtype).split('.')[-1]}")
    tokens = spec.num_sampled * spec.local_steps * spec.local_batch * (
        text_len + cfg.num_prefix_tokens)
    secs, peaks, losses = [], [], []
    reset_launches()
    for r in range(rounds):
        batch = _fed_batch(cfg, spec, text_len, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x, c, c_i, m = federated_round(grad_fn, spec, x, c, c_i, batch,
                                       use_fused_update=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(float(m["loss"]))
        log(f"{tag} round {r + 1}: loss {losses[-1]:.4f}, drift "
            f"{float(m['drift']):.4e}, {secs[-1]:.3f} s, "
            f"{tokens / secs[-1]:.1f} tokens/s ({tokens} tokens), peak "
            f"device memory {peaks[-1] / 1e9:.2f} GB (planned "
            f"{plan / 1e9:.2f} GB), peak host memory {host_peak_gb():.1f} GB")
        if not (math.isfinite(losses[-1]) and math.isfinite(
                float(m["drift"]))):
            raise AssertionError(f"{tag} round {r + 1}: non-finite {m}")
    counts = launches()
    finite = all(bool(torch.isfinite(v).all())
                 for t in (x, c) for v in t.values())
    if not finite:
        raise AssertionError(f"{tag}: non-finite x or c after {rounds} "
                             f"rounds")
    del c_i
    torch.cuda.empty_cache()
    result["b1"].setdefault("trees", {})[tag] = _time_update_tree(
        f"scaffold_update at the {tag} tree", x, c, spec.eta_l)
    del x, c
    torch.cuda.empty_cache()
    return counts, secs, peaks, losses


def _want_b1(tag, counts, spec, groups, rounds, b5=0):
    """Hold the launch counts to B1 = S x K x groups x rounds and B5 =
    ``b5``, nothing else; returns the B1 count."""
    steps = spec.num_sampled * spec.local_steps
    want = {k: 0 for k in counts}
    want.update(scaffold_update=steps * groups * rounds, swa_attention=b5)
    log(f"{tag}: launches {counts}; want scaffold_update = S "
        f"{spec.num_sampled} x K {spec.local_steps} x groups {groups} x "
        f"rounds {rounds} = {want['scaffold_update']}, swa_attention {b5}, "
        f"nothing else")
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")
    return want["scaffold_update"]


def phase_minitron_full(result):
    """Phase 36: minitron-4b at its published widths (two 0.79e9 vocab
    tables, bf16), seq 2048: ``head_only`` on ``unembed*,ln_final*`` at
    all 32 layers through ``repro_torch.launch.train.main`` (B1 on the
    2-leaf bf16 group); then the full space through the trainer at the
    depth ``_lm_plan`` admits, logged as a cut (B1 on the one bf16
    group); launch counts exact, round times, memory against the plan;
    B1 held to its plain version and timed on both trees."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    seq_len, rounds = 2048, 2
    steps = 2 * 2
    cfg = dataclasses.replace(get_config("minitron-4b"),
                              loss_chunk_vocab=MINITRON_CHUNK)
    elements, plan = _subset_plan("head_only minitron", cfg, seq_len,
                                  "head_only", stack_grads=False)
    reset_launches()
    with _RoundLog("head_only minitron", steps * seq_len, plan) as rl:
        tr = train.main(_train_argv("minitron-4b", seq_len, rounds,
                                    MINITRON_CHUNK, "--update-space",
                                    "head_only", "--lora-targets",
                                    MINITRON_HEAD))
    counts = launches()
    if sorted(tr.x) != ["ln_final.scale", "unembed"] or any(
            v.dtype != torch.bfloat16 for v in tr.x.values()):
        raise AssertionError(f"head_only minitron: delta tree "
                             f"{ {k: v.dtype for k, v in tr.x.items()} }")
    _check_subset_rounds("head_only minitron", tr, rl.rows, "head_only",
                         elements, 2)
    n = _want_b1("head_only minitron", counts, tr.spec, 1, rounds)
    result.setdefault("b1_paths", {})["head_only minitron-4b"] = n
    result["b1"].setdefault("trees", {})["minitron head_only"] = (
        _time_update_tree("scaffold_update at the minitron-4b head_only tree "
                          "(the 0.79e9-element unembed)", tr.x, tr.c,
                          tr.spec.eta_l))
    tr.close()
    del tr
    torch.cuda.empty_cache()

    spec, rounds = _lm_spec(), 2
    log("reduced: minitron full-space rounds 3 -> 2 (the script's time)")
    cut, _, _ = _lm_fit(spec, seq_len, arch="minitron-4b",
                        chunk=MINITRON_CHUNK)
    plan = _lm_plan(cut, seq_len, spec.local_batch)[2]
    tr, counts, secs, peaks = _lm_rounds("minitron", cut, spec, seq_len,
                                         rounds, plan)
    groups = len(_b1_groups(tr))
    n = _want_b1("minitron", counts, spec, groups, rounds)
    _plan_vs_peak(f"minitron at {cut.num_layers} layers", plan, max(peaks))
    log(f"minitron: rounds 2-{rounds} mean {statistics.mean(secs[1:]):.3f} "
        f"s at {cut.num_layers} of {cfg.num_layers} layers")
    if groups != 1 or n != 8 or "unembed" not in tr.x:
        raise AssertionError(f"minitron: {groups} groups, B1 {n}")
    result.setdefault("b1_paths", {})["minitron-4b"] = n
    torch.cuda.empty_cache()
    log(f"minitron: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before B1 is timed on its tree")
    result["b1"]["trees"][f"minitron {cut.num_layers} layers"] = (
        _time_update_tree(f"scaffold_update at the minitron-4b tree "
                          f"({cut.num_layers} layers, both vocab tables)",
                          tr.x, tr.c, spec.eta_l))
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_paligemma_full(result):
    """Phase 37: paligemma-3b at its published widths, all 18 layers in
    bf16, 256 projected patches + 1792 text tokens (2048: the dense
    prefix-LM path), SCAFFOLD through ``federated_round``: B1 on the one
    bf16 group, no B5; round times and memory against the plan; B1 held
    to its plain version and timed on the trained tree."""
    from repro_torch.configs import get_config

    spec, rounds = _lm_spec(), 3
    cfg = dataclasses.replace(get_config("paligemma-3b"),
                              loss_chunk_vocab=PALIGEMMA_CHUNK)
    seq_len = 2048
    text_len = seq_len - cfg.num_prefix_tokens
    plan = _lm_plan(cfg, seq_len, spec.local_batch)[2]
    log(f"paligemma: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}q/{cfg.num_kv_heads}kv x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_prefix_tokens} prefix "
        f"+ {text_len} text tokens; plan {plan / 1e9:.2f} GB (limit "
        f"{LM_MEMORY_LIMIT / 1e9:.0f} GB)")
    if plan > LM_MEMORY_LIMIT:
        raise AssertionError(f"paligemma: plan {plan / 1e9:.1f} GB")
    counts, secs, peaks, losses = _fed_rounds("paligemma", cfg, spec,
                                              text_len, rounds, plan, result)
    n = _want_b1("paligemma", counts, spec, 1, rounds)
    _plan_vs_peak("paligemma", plan, max(peaks))
    log(f"paligemma: rounds 2-{rounds} mean {statistics.mean(secs[1:]):.3f}"
        f" s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    result.setdefault("b1_paths", {})["paligemma-3b"] = n


def phase_gemma_long(result):
    """Phase 38: gemma3-1b at its published widths and all 26 layers,
    seq 4096: the 22 "W" layers through B5 (4096 = 8 windows), the 4 "F"
    layers past 2048 tokens through ``flash_attention``; B1 on the one
    bf16 group; launch counts exact, round times, memory against the
    plan, a profiled round."""
    import torch

    from repro_torch.configs import get_config

    seq_len, rounds = 4096, 3
    spec = _lm_spec()
    cfg, _, _ = _lm_fit(spec, seq_len, arch="gemma3-1b",
                        chunk=get_config("gemma3-1b").vocab_size // 16)
    if cfg.num_layers != get_config("gemma3-1b").num_layers:
        raise AssertionError(f"gemma long: depth cut to {cfg.num_layers}")
    plan = _lm_plan(cfg, seq_len, spec.local_batch)[2]
    n_w = cfg.pattern_for_layers().count("W")
    steps = spec.num_sampled * spec.local_steps
    tr, counts, secs, peaks = _lm_rounds("gemma long", cfg, spec, seq_len,
                                         rounds, plan)
    n = _want_b1("gemma long", counts, spec, 1, rounds,
                 b5=n_w * steps * rounds)
    _plan_vs_peak("gemma long", plan, max(peaks))
    log(f"gemma long: {n_w} W layers x S x K x rounds = "
        f"{counts['swa_attention']} B5 launches, "
        f"{cfg.pattern_for_layers().count('F')} F layers through "
        f"flash_attention; rounds 2-{rounds} mean "
        f"{statistics.mean(secs[1:]):.3f} s")
    result.setdefault("b1_paths", {})["gemma3-1b seq 4096"] = n
    result.setdefault("b5_paths", {})["gemma3-1b seq 4096"] = counts[
        "swa_attention"]
    log("reduced: gemma long, no profiled round (the script's time; its "
        "busy share is in PERF.md from earlier runs)")
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_whisper_full(result):
    """Phase 39: whisper-tiny at its published widths (4 + 4 layers,
    d_model 384, fp32), 1500 frames and 448 text tokens, batch 4,
    SCAFFOLD through ``federated_round``: B1 on the one fp32 group; round
    times and memory against the plan; B1 held to its plain version and
    timed on the trained tree."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec

    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=4, eta_l=0.01,
                        strategy="client_sequential")
    cfg, text_len, rounds = get_config("whisper-tiny"), 448, 3
    plan = _lm_plan(cfg, text_len, spec.local_batch)[2]
    log(f"whisper: {cfg.num_layers} + {cfg.encoder.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff} (gelu), layer norm, vocab {cfg.vocab_size}, "
        f"{cfg.encoder.num_frames} frames, {text_len} text tokens, batch "
        f"{spec.local_batch}, fp32; plan {plan / 1e9:.2f} GB")
    counts, secs, peaks, losses = _fed_rounds("whisper", cfg, spec, text_len,
                                              rounds, plan, result)
    n = _want_b1("whisper", counts, spec, 1, rounds)
    _plan_vs_peak("whisper", plan, max(peaks))
    log(f"whisper: rounds 2-{rounds} mean {statistics.mean(secs[1:]):.3f} s;"
        f" loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    result.setdefault("b1_paths", {})["whisper-tiny"] = n


# ---------------------------------------------------------------------------
# decode and serving; MLA (minicpm3-4b)
# ---------------------------------------------------------------------------

# phase 40's reduced archs and decode lengths: the parity tests' (gemma3
# and hymba past their windows of 64), whisper's 24 text tokens over 64
# frames, paligemma's 16 steps
DECODE_SMALL = (("llama3.2-3b", 32), ("gemma3-1b", 192), ("mamba2-2.7b", 64),
                ("hymba-1.5b", 128), ("minitron-4b", 32), ("whisper-tiny", 24),
                ("paligemma-3b", 16), ("minicpm3-4b", 32),
                ("qwen2-moe-a2.7b", 32), ("deepseek-v3-671b", 32))
# bf16 decode against the bf16 prefill, max |diff| over max |logit| at
# the last 64 positions (phase 41, gemma3-1b; phase 45, minicpm3-4b):
# set before the first card run at 3x the CPU's 0.032 (gemma3) and 0.027
# (minicpm3) at the reduced widths and full depth; a ring, mask or latent
# fault gives O(1)
BF16_DECODE_BOUND = 0.1
# fp32 prefill (the SSD's chunked form) against decode (its recurrence,
# fp32 state) at SSM_CHECK_TOKENS tokens, published widths, max |diff|
# over max |logit| (phase 42): in bf16 the two forms' roundings differ (the
# chunked conv rounds each of its K products) and a random 64-layer
# stack amplifies them to 0.71 of max |logit| at the reduced width (CPU),
# so fp32 is held; the CPU gives 4.4e-4 at the reduced width and 64
# layers, 4.5e-5 at the published width and 2 layers
SSM_DECODE_BOUND = 1e-2
# card against CPU decode and decode against the forward, max |diff| of
# the fp32 logits (phase 40; the latter is the JAX package's own test's
# bound)
DECODE_CPU_BOUND, DECODE_FORWARD_BOUND = 1e-4, 5e-4
SERVE_ARCHS = ("llama3.2-3b", "minitron-4b", "mamba2-2.7b", "hymba-1.5b")
SERVE_ARGS = ("--preset", "full", "--batch", "8", "--prompt-len", "64",
              "--max-new", "32")
# phase 41's decode steps of gemma3-1b's 1024-token prefill: past the
# 512-slot ring, so it wraps (cut from all 1024 for the script's time),
# and its generate's new tokens (128 before the same cut)
GEMMA_DECODE_STEPS, GEMMA_NEW_TOKENS = 576, 64
# the tokens of phase 45's decode-against-prefill check at published
# widths (256 before the cut for the script's time), and of
# phase 42's fp32 SSD forms (256 before the same cut)
DECODE_CHECK_TOKENS, SSM_CHECK_TOKENS = 128, 64
MINICPM_CHUNK = 18362  # minicpm3-4b's CE vocab chunk (4 of its 73448)
# the sequences phase 45 tries for LoRA at all 62 layers, longest first
MINICPM_SEQS = (2048, 1024, 512)
# the most layers phase 45's full space trains (the plan admitted 48 before
# a cut for the script's time)
MINICPM_FULL_LAYERS = 24


@contextlib.contextmanager
def _no_host_sync():
    """Within the block a host sync with the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def _guarded_generate():
    """``repro_torch.launch.serve.generate`` runs under ``_no_host_sync``
    within the block (``serve.main`` times it with syncs around it)."""
    from repro_torch.launch import serve

    inner = serve.generate

    def guarded(*args, **kw):
        with _no_host_sync():
            return inner(*args, **kw)

    serve.generate = guarded
    try:
        yield
    finally:
        serve.generate = inner


def _decode_tokens(cfg, params, tokens, cache, keep=None):
    """``decode_step`` over every column of ``tokens`` (B, S) from
    ``cache``, position i at step i, in inference mode, on the card under
    ``_no_host_sync``;
    returns the logits (B, n, V) of the last ``keep`` steps (all when
    None) and the host seconds of the steps, the card synchronised
    after."""
    import torch

    from repro_torch.models import model as M

    b, s = tokens.shape
    dev = tokens.device
    guard = _no_host_sync() if dev.type == "cuda" else contextlib.nullcontext()
    out = []
    t0 = time.perf_counter()
    with torch.inference_mode(), guard:
        for i in range(s):
            lg, cache = M.decode_step(
                cfg, params, cache, tokens[:, i:i + 1],
                torch.full((b,), i, dtype=torch.int32, device=dev))
            if keep is None or i >= s - keep:
                out.append(lg[:, 0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return torch.stack(out, dim=1), time.perf_counter() - t0


def _band_layers(cfg, seq_len: int) -> int:
    """Layers whose prefill at ``seq_len`` takes B5: ``"W"`` (and a
    windowed ``"Y"``) layers at S a multiple of the window, two windows
    or more."""
    w = cfg.sliding_window
    if not w or seq_len % w or seq_len < 2 * w:
        return 0
    return sum(k in "WY" for k in cfg.pattern_for_layers())


def _want_only(tag, counts, **nonzero) -> None:
    """Hold the launch counts to ``nonzero`` and 0 for every other."""
    want = _want_launches(**nonzero)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} != {want}")


def _peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def phase_decode_small(result):
    """Phase 40: every ported family's reduced fp32 config (llama, gemma3
    past its window, mamba2, hymba past its window, minitron, whisper
    over 64 frames, paligemma, minicpm3's MLA, qwen2-moe and deepseek's
    MLA + MoE under the ragged dispatch, as the reference's decode test
    runs them): ``decode_step`` on the card (no host sync) against the
    same steps on the CPU within 1e-4, and against ``prefill`` on the
    card within 5e-4 (not paligemma: its forward attends to the image
    prefix, which a text decode has not seen); no kernel of B1-B5 in
    decode, B5 on the prefill's band layers, G1 three times an MoE layer
    a step (the ragged dispatch's fp32 grouped products). Then the MoE
    models' gshard federated round card vs CPU, the ragged block against
    gshard at capacity factor 8 on the card, and G1 against its plain
    version (``_check_grouped_mm``)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M

    b5 = g1 = 0
    for arch, s in DECODE_SMALL:
        cfg = get_reduced(arch)
        n_moe = 0
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe_impl="ragged")
            n_moe = _moe_layers(cfg)
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        p_card = {k: v.cuda() for k, v in p_cpu.items()}
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                         generator=gen)}
        if cfg.encoder is not None:
            batch["frames"] = torch.randn(
                (2, cfg.encoder.num_frames, cfg.d_model), generator=gen)
        if cfg.num_prefix_tokens:
            batch["patches"] = torch.randn(
                (2, cfg.num_prefix_tokens, cfg.d_model), generator=gen)
        logits = {}
        reset_launches()
        for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
            cache = M.init_cache(cfg, 2, s, device=dev)
            if cfg.encoder is not None:
                frames = batch["frames"].to(dev)
                guard = (_no_host_sync() if dev == "cuda"
                         else contextlib.nullcontext())
                with torch.no_grad(), guard:
                    M.populate_encoder_cache(cfg, p, cache, frames)
            logits[dev], _ = _decode_tokens(cfg, p, batch["tokens"].to(dev),
                                            cache)
        _want_only(f"decode check {arch}", launches(),
                   grouped_mm=3 * n_moe * s)
        g1 += 3 * n_moe * s
        err_cpu = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
        msg = (f"decode check: 2-layer fp32 {arch}, {s} decode steps on the "
               f"card (no host sync) vs the CPU: max |diff| {err_cpu:.2e} "
               f"(bound {DECODE_CPU_BOUND:.0e})")
        err_fwd = 0.0
        if not cfg.num_prefix_tokens:
            reset_launches()
            with torch.no_grad():
                full = M.prefill(cfg, p_card, {k: v.cuda() for k, v in
                                               batch.items()})
            n_band = _band_layers(cfg, s)
            _want_only(f"decode check {arch} prefill", launches(),
                       swa_attention=n_band, grouped_mm=3 * n_moe)
            b5 += n_band
            g1 += 3 * n_moe
            err_fwd = float((logits["cuda"] - full).abs().max())
            msg += (f"; vs prefill on the card {err_fwd:.2e} (bound "
                    f"{DECODE_FORWARD_BOUND:.0e}), B5 {n_band} in the "
                    f"prefill")
        log(msg)
        if not (err_cpu <= DECODE_CPU_BOUND
                and err_fwd <= DECODE_FORWARD_BOUND):
            raise AssertionError(f"decode check {arch}: {err_cpu} "
                                 f"{err_fwd}")
    result.setdefault("b5_paths", {})["reduced prefill vs decode"] = b5
    result.setdefault("g1_paths", {})["reduced MoE prefill vs decode"] = g1
    _moe_small_checks(result)
    _check_grouped_mm(result)


def _decode_rate(tag, batch, new, steps, secs):
    log(f"{tag}: {steps} decode steps in {secs:.3f} s, "
        f"{1e3 * secs / steps:.2f} ms a step, {batch * new / secs:.1f} new "
        f"tokens/s ({batch} x {new}), peak device memory "
        f"{_peak_gb():.2f} GB")


def _prefill_vs_decode(tag, cfg, params, seq_len, bound, b=2, keep=None,
                       steps=None):
    """``prefill`` of a seeded (b, seq_len) token batch against the first
    ``steps`` (all when None) of the same tokens through ``decode_step``
    (no host sync; a causal model's logits at a position read no later
    token): max |diff| over max |logit| at the last ``keep`` decoded
    positions (all when None), held to ``bound``; returns the launches of
    the prefill and of the decode, the decode's host seconds and its
    cache."""
    import torch

    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, seq_len), generator=gen,
                           device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = steps or seq_len
    with torch.no_grad():
        full = M.prefill(cfg, params, {"tokens": tokens})
        full = full[:, steps - (keep or steps):steps].float()
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = launches()
    reset_launches()
    cache = M.init_cache(cfg, b, seq_len)
    dec, secs = _decode_tokens(cfg, params, tokens[:, :steps], cache,
                               keep=keep)
    rel = float((dec.float() - full).abs().max() / full.abs().max())
    log(f"{tag}: prefill of {b} x {seq_len} tokens {t_pre:.3f} s; "
        f"{steps} decode steps {secs:.3f} s ({1e3 * secs / steps:.2f} "
        f"ms a step); decode vs prefill max |diff| / max |logit| "
        f"{rel:.3e} over the last {keep or steps} decoded positions (bound "
        f"{bound:.0e}); launches: prefill {pre}, decode {launches()}")
    if not rel <= bound:
        raise AssertionError(f"{tag}: decode vs prefill {rel} > {bound}")
    return pre, launches(), secs, cache


def phase_gemma_serve(result):
    """Phase 41: gemma3-1b at its published widths, 26 layers, bf16:
    ``prefill`` at batch 2 x 1024 tokens (each of the 22 "W" layers one
    B5 launch: 1024 = 2 windows), then the first ``GEMMA_DECODE_STEPS``
    of the same tokens through ``decode_step`` (each "W" layer's 512-slot
    ring wraps), the last 64 decoded positions' logits against the
    prefill's within BF16_DECODE_BOUND; then ``generate``
    GEMMA_NEW_TOKENS new tokens
    after an 8-token prompt: ms a step, tokens/s, peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config("gemma3-1b")
    b, s, keep = 2, 1024, 64
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    n_w = _band_layers(cfg, s)
    log(f"reduced: gemma serve decode steps {s} -> {GEMMA_DECODE_STEPS} "
        f"(the ring still wraps; the prefill stays at {s})")
    pre, dec, secs, cache = _prefill_vs_decode(
        "gemma serve", cfg, params, s, BF16_DECODE_BOUND, b=b, keep=keep,
        steps=GEMMA_DECODE_STEPS)
    _want_only("gemma serve prefill", pre, swa_attention=n_w)
    _want_only("gemma serve decode", dec)
    ring = tuple(cache["layers/0/attn/k"].shape)
    log(f"gemma serve: B5 {pre['swa_attention']} launches in the prefill "
        f"(want {n_w} W layers, 22); W cache {ring} (a 512-slot ring for "
        f"{GEMMA_DECODE_STEPS} tokens); "
        f"{b * GEMMA_DECODE_STEPS / secs:.1f} tokens/s through decode_step; "
        f"peak device memory {_peak_gb():.2f} GB")
    if n_w != 22 or ring[2] != cfg.sliding_window:
        raise AssertionError(f"gemma serve: {n_w} band layers, ring {ring}")
    result.setdefault("b5_paths", {})["gemma3-1b prefill"] = n_w
    del cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.randint(0, cfg.vocab_size, (b, 8), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(3))
    reset_launches()
    t0 = time.perf_counter()
    with _guarded_generate():
        out = serve.generate(cfg, params, prompts, GEMMA_NEW_TOKENS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _want_only("gemma generate", launches())
    _decode_rate("gemma serve generate", b, GEMMA_NEW_TOKENS,
                 8 + GEMMA_NEW_TOKENS, secs)
    if out.shape != (b, GEMMA_NEW_TOKENS) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"gemma generate: {out.shape}")


def phase_serve_full(result):
    """Phase 42: ``repro_torch.launch.serve.main --preset full --batch 8
    --prompt-len 64 --max-new 32`` for llama3.2-3b, minitron-4b
    (untied), mamba2-2.7b and hymba-1.5b, ``generate`` under
    ``_no_host_sync``: tokens/s, ms a step, peak memory; then mamba2-2.7b
    and hymba-1.5b in fp32 at their published widths, prefill (the SSD's
    chunked form) against decode (its recurrence) at SSM_CHECK_TOKENS
    tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    log("reduced: serve --prompt-len 128 --max-new 128 -> --prompt-len 64 "
        "--max-new 32 (llama3.2-3b, minitron-4b, mamba2-2.7b, hymba-1.5b); "
        f"fp32 prefill vs decode 256 -> {SSM_CHECK_TOKENS} tokens (the "
        f"script's time)")
    for arch in SERVE_ARCHS:
        reset_launches()
        with _guarded_generate():
            served = serve.main(["--arch", arch, *SERVE_ARGS])
        _want_only(f"serve {arch}", launches())
        tok = served.tokens
        log(f"serve {arch}: {served.steps} steps, {served.ms_per_step:.2f} ms"
            f" a step, {tok.numel() / served.seconds:.1f} new tokens/s, peak "
            f"device memory {served.peak_bytes / 1e9:.2f} GB")
        vocab = get_config(arch).vocab_size
        if tok.shape != (8, 32) or int(tok.min()) < 0 or \
                int(tok.max()) >= vocab:
            raise AssertionError(f"serve {arch}: tokens {tok.shape}")
        del served, tok
        torch.cuda.empty_cache()
    for arch in ("mamba2-2.7b", "hymba-1.5b"):
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  compute_dtype="float32")
        params = M.init_params(cfg,
                               torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        pre, dec, _, cache = _prefill_vs_decode(
            f"{arch} fp32 prefill vs decode", cfg, params, SSM_CHECK_TOKENS,
            SSM_DECODE_BOUND)
        _want_only(f"{arch} prefill", pre)
        _want_only(f"{arch} decode", dec)
        state = cache["layers/0/mamba/state"]
        log(f"{arch} fp32: state {tuple(state.shape)} {state.dtype}; peak "
            f"device memory {_peak_gb():.2f} GB")
        del params, cache, state
        torch.cuda.empty_cache()


def phase_serve_checkpoint(result):
    """Phase 43: the closed train-to-serve loop. ``serve.main --arch
    gemma3-1b --preset full --checkpoint`` of phase 19's LoRA checkpoint
    serves the merged parameters ("serving merged checkpoint"), bitwise
    ``load_serving_params``'; a mismatched ``--arch`` is refused."""
    import torch

    from repro_torch.checkpoint import load_serving_params
    from repro_torch.launch import serve

    path = result.pop("lora_gemma_ckpt")
    text = io.StringIO()
    with _guarded_generate(), contextlib.redirect_stdout(text):
        served = serve.main(["--arch", "gemma3-1b", "--preset", "full",
                             "--checkpoint", path, "--batch", "2",
                             "--prompt-len", "16", "--max-new", "16"])
    lines = text.getvalue().splitlines()
    want = load_serving_params(path)
    apart = [k for k in want if not torch.equal(served.params[k], want[k])]
    log(f"serve checkpoint: {lines[0]!r}; {len(served.params)} leaves, "
        f"{len(apart)} apart from load_serving_params (want 0); "
        f"{served.ms_per_step:.2f} ms a step")
    if not lines[0].startswith("serving merged checkpoint") or apart or \
            sorted(want) != sorted(served.params):
        raise AssertionError(f"serve checkpoint: {lines[:2]}, {apart[:4]}")
    del served, want
    torch.cuda.empty_cache()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--arch", "llama3.2-3b", "--preset", "full",
                        "--checkpoint", path])
    except SystemExit as e:
        log(f"serve checkpoint: --arch llama3.2-3b refused: "
            f"{str(e)[:90]}...")
    else:
        raise AssertionError("serve checkpoint: a mismatched --arch served")
    Path(path).unlink()
    torch.cuda.empty_cache()


def phase_encdec_serve(result):
    """Phase 44: whisper-tiny at its published widths (fp32):
    ``populate_encoder_cache`` over 1500 frames, then 448 decode steps
    against the teacher-forced forward within 5e-4; paligemma-3b at its
    published widths (bf16): 16 decode steps, finite (phase 40 holds its
    reduced config to the CPU)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("whisper-tiny")
    b, s = 2, 448
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    frames = torch.randn((b, cfg.encoder.num_frames, cfg.d_model),
                         generator=gen, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        full = M.prefill(cfg, params, {"tokens": tokens, "frames": frames})
    cache = M.init_cache(cfg, b, s)
    t0 = time.perf_counter()
    with torch.no_grad(), _no_host_sync():
        M.populate_encoder_cache(cfg, params, cache, frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    dec, secs = _decode_tokens(cfg, params, tokens, cache)
    err = float((dec - full).abs().max())
    _want_only("whisper serve", launches())
    log(f"whisper serve: populate_encoder_cache over "
        f"{cfg.encoder.num_frames} frames {t_enc:.3f} s; {s} decode steps "
        f"{secs:.3f} s ({1e3 * secs / s:.2f} ms a step); max |diff| to the "
        f"teacher-forced forward {err:.2e} (bound {DECODE_FORWARD_BOUND:.0e})"
        f"; peak device memory {_peak_gb():.2f} GB")
    if not err <= DECODE_FORWARD_BOUND:
        raise AssertionError(f"whisper serve: {err}")
    del params, cache, full, dec
    torch.cuda.empty_cache()

    cfg = get_config("paligemma-3b")
    steps = 16
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, steps), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    dec, secs = _decode_tokens(cfg, params, tokens,
                               M.init_cache(cfg, b, steps))
    finite = bool(torch.isfinite(dec).all())
    _want_only("paligemma serve", launches())
    _decode_rate("paligemma serve", b, steps, steps, secs)
    if not finite or dec.shape != (b, steps, cfg.vocab_size):
        raise AssertionError(f"paligemma serve: {dec.shape}, finite "
                             f"{finite}")
    del params, dec
    torch.cuda.empty_cache()


def phase_minicpm3(result):
    """Phase 45: minicpm3-4b (MLA) at its published widths, bf16, through
    ``repro_torch.launch.train.main``: LoRA r 8 on the default targets
    (``wo`` and the MLP: MLA's factored projections are not targeted) at
    all 62 layers at the longest of ``MINICPM_SEQS`` whose plan fits (the
    dense "F" layers' probabilities are ~1 GB a layer at 2048), B1 on the
    fp32 delta tree. Then the full space through the trainer at the
    depth ``_lm_plan`` admits at that sequence, logged as a cut (B1 on
    the one bf16 group), and the trained model served: prefill against
    MLA's absorbed decode at DECODE_CHECK_TOKENS tokens within
    BF16_DECODE_BOUND."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    base = dataclasses.replace(get_config("minicpm3-4b"),
                               loss_chunk_vocab=MINICPM_CHUNK)
    n_t, n_delta = _space_sizes(base, "lora", LORA_RANK)
    for seq_len in MINICPM_SEQS:
        plan = _lm_plan(base, seq_len, 1, subset=(n_t, 4 * n_delta))[2]
        log(f"minicpm3: LoRA plan at seq {seq_len}, 62 layers: "
            f"{plan / 1e9:.1f} GB (limit {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
        if plan <= LM_MEMORY_LIMIT:
            break
    if seq_len != MINICPM_SEQS[0]:
        log(f"reduced: seq {MINICPM_SEQS[0]} -> {seq_len} (minicpm3-4b, "
            f"depth kept at {base.num_layers} for LoRA)")
    elements, plan = _subset_plan("lora minicpm3", base, seq_len, "lora",
                                  LORA_RANK)
    rounds, steps = 2, 2 * 2
    reset_launches()
    with _RoundLog("lora minicpm3", steps * seq_len, plan) as rl:
        tr = train.main(_train_argv("minicpm3-4b", seq_len, rounds,
                                    MINICPM_CHUNK, "--update-space", "lora",
                                    "--lora-rank", str(LORA_RANK)))
    counts = launches()
    _check_subset_rounds("lora minicpm3", tr, rl.rows, "lora", elements, 4)
    targets = sorted({k.rsplit("/", 1)[0].rsplit(".", 1)[-1] for k in tr.x})
    log(f"lora minicpm3: {len(tr.x)} delta leaves on {targets}")
    if targets != ["w_down", "w_gate", "w_up", "wo"]:
        raise AssertionError(f"lora minicpm3: delta tree {sorted(tr.x)}")
    n = _want_b1("lora minicpm3", counts, tr.spec, 1, rounds)
    result.setdefault("b1_paths", {})["lora minicpm3-4b"] = n
    tr.close()
    del tr
    torch.cuda.empty_cache()

    spec, rounds = _lm_spec(), 2
    log(f"reduced: minicpm3 full space at most {MINICPM_FULL_LAYERS} layers "
        f"(the script's time)")
    cut, _, _ = _lm_fit(spec, seq_len, arch="minicpm3-4b",
                        chunk=MINICPM_CHUNK, max_layers=MINICPM_FULL_LAYERS)
    plan = _lm_plan(cut, seq_len, spec.local_batch)[2]
    tr, counts, secs, peaks = _lm_rounds("minicpm3", cut, spec, seq_len,
                                         rounds, plan)
    groups = len(_b1_groups(tr))
    n = _want_b1("minicpm3", counts, spec, groups, rounds)
    _plan_vs_peak(f"minicpm3 at {cut.num_layers} layers", plan, max(peaks))
    if groups != 1:
        raise AssertionError(f"minicpm3: {groups} groups")
    result.setdefault("b1_paths", {})["minicpm3-4b"] = n
    served = tr.eval_params()
    tr.close()
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"reduced: minicpm3 decode vs prefill 256 -> {DECODE_CHECK_TOKENS} "
        f"tokens (the script's time)")
    pre, dec, _, cache = _prefill_vs_decode(
        f"minicpm3 served ({cut.num_layers} layers, trained) MLA", cut,
        served, DECODE_CHECK_TOKENS, BF16_DECODE_BOUND)
    _want_only("minicpm3 prefill", pre)
    _want_only("minicpm3 decode", dec)
    log(f"minicpm3 served: latent cache ckv "
        f"{tuple(cache['layers/0/attn/ckv'].shape)}, k_rope "
        f"{tuple(cache['layers/0/attn/k_rope'].shape)}; peak device memory "
        f"{_peak_gb():.2f} GB")
    del served, cache
    torch.cuda.empty_cache()


# qwen2-moe-a2.7b's and deepseek-v3-671b's CE vocab chunks (8 of 151936,
# 8 of 129280)
QWEN_CHUNK, DEEPSEEK_CHUNK = 18992, 16160
# phase 48: deepseek-v3-671b's 3 dense layers and one MoE layer
DEEPSEEK_LAYERS = 4
# phase 48's LoRA targets: MLA's wo, the dense layers' MLP and the shared
# expert. The routed experts' merged copy and its gradient (256 x 3 x
# 7168 x 2048 bf16: 22.5 GB each) do not fit beside the ~28.4 GB frozen
# base
DEEPSEEK_TARGETS = "wo,*mlp.w_*,*shared.w_*"
# the sequences phase 48 tries, longest first
DEEPSEEK_SEQS = (2048, 1024, 512)
QWEN_SERVE_ARGS = ("--arch", "qwen2-moe-a2.7b", "--preset", "full",
                   "--batch", "8", "--prompt-len", "128", "--max-new", "64")
# ragged against gshard at capacity factor 8 (no drops) on the card: the
# bounds of the JAX package's tests/test_moe.py
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5
# the tokens of phases 47-48's MoE decode against prefill (routing pinned
# to the prefill's, so every position is held)
MOE_CHECK_TOKENS = 256
# the rows of the evaluation batch launch.train runs after each round
EVAL_ROWS = 8
# G1 against its plain version, max |diff| over the plain output's
# largest element (fp32 both; the two sum each element in another order)
G1_BOUND = 1e-5
# G1's cases, (rows, K, N, group ends): the reduced MoE's decode step
# (batch 2 x top 2 rows, expert 1 empty), its prefill of 2 x 32 tokens
# (128 rows) into w_gate/w_up (256 -> 128) and into w_down (128 -> 256)
G1_CASES = ((4, 256, 128, (2, 2, 3, 4)), (128, 256, 128, (40, 64, 64, 128)),
            (128, 128, 256, (40, 64, 64, 128)))


def _moe_layers(cfg) -> int:
    return sum(cfg.layer_uses_moe(i) for i in range(cfg.num_layers))


@contextlib.contextmanager
def _routes(pinned=None, b: int = 1):
    """Within the block every MoE router call's own expert ids (tokens,
    k) are appended, in call order, to the list yielded. With ``pinned``
    (the prefill's ids, (b*S, k) for each of its n MoE layers) call j,
    the decode's step j // n in layer j % n, returns instead that
    layer's ids at position j // n, each weighted by the call's own
    router probability, renormalised as the router does. No host
    sync."""
    import torch

    from repro_torch.models import layers as L

    inner, calls = L._router, []
    rows = [ids.reshape(b, -1, ids.shape[-1]) for ids in pinned or ()]

    def router(cfg, p, xf):
        w, ids, aux = inner(cfg, p, xf)
        j = len(calls)
        calls.append(ids)
        if not rows:
            return w, ids, aux
        ids = rows[j % len(rows)][:, j // len(rows)]
        probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
        w = probs.gather(-1, ids)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids, aux

    L._router = router
    try:
        yield calls
    finally:
        L._router = inner


def _route_flips(pre_calls, dec_calls, b: int, steps: int):
    """The count of (layer, row, position) routings whose expert set
    differs between the prefill's router calls (one a MoE layer, (b*S,
    k)) and the decode's own (one a layer a step, (b, k)), and the first
    position where one does (``steps`` when none does)."""
    import torch

    n = len(pre_calls)
    pre = torch.stack([c.reshape(b, -1, c.shape[-1])[:, :steps]
                       for c in pre_calls])  # (n, b, steps, k)
    dec = torch.stack(dec_calls).reshape(steps, n, b, -1).permute(1, 2, 0, 3)
    differ = (pre.sort(-1).values != dec.sort(-1).values).any(-1)
    at = differ.any(1).any(0).nonzero()
    return int(differ.sum()), int(at[0]) if len(at) else steps


def _moe_prefill_vs_decode(tag, cfg, params, seq_len, bound, b=2):
    """``prefill`` of a seeded (b, seq_len) token batch against the same
    tokens through ``decode_step`` (no host sync), max |diff| / max
    |logit| over every position held to ``bound``. A routing is a
    discontinuity: where a near-tie of the router's probabilities is
    broken apart by the two paths' roundings, a token's top-k expert set
    differs and, through attention, so does every later position. So the
    decode's routing is pinned to the prefill's (``_routes``), its
    weights its own, and the routings the decode would have chosen
    otherwise are counted. Returns the launches of the prefill and of
    the decode, the decode's host seconds and its cache."""
    import torch

    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, seq_len), generator=gen,
                           device="cuda")
    n_moe = _moe_layers(cfg)
    reset_launches()
    with torch.no_grad(), _routes() as pre_calls:
        full = M.prefill(cfg, params, {"tokens": tokens}).float()
    torch.cuda.synchronize()
    pre = launches()
    reset_launches()
    cache = M.init_cache(cfg, b, seq_len)
    with _routes(pre_calls, b) as dec_calls:
        dec, secs = _decode_tokens(cfg, params, tokens, cache)
    flips, first = _route_flips(pre_calls, dec_calls, b, seq_len)
    rel = float((dec.float() - full).abs().max() / full.abs().max())
    log(f"{tag}: {seq_len} decode steps {secs:.3f} s "
        f"({1e3 * secs / seq_len:.2f} ms a step), routing pinned to the "
        f"prefill's: the decode's own would differ in {flips} of "
        f"{n_moe * b * seq_len} (layer, row, position) expert sets, the "
        f"first at position {first}; decode vs prefill max |diff| / max "
        f"|logit| {rel:.3e} over all {seq_len} positions (bound "
        f"{bound:.0e}); launches: prefill {pre}, decode {launches()}")
    if not rel <= bound:
        raise AssertionError(f"{tag}: decode vs prefill {rel}")
    return pre, launches(), secs, cache


def _check_grouped_mm(result) -> None:
    """G1, the fp32 grouped product, on the card against its plain
    version (one ``@`` a group, on the card) at ``G1_CASES``: forward,
    the input gradient (the forward on b transposed) and the weight
    gradient (zeros for the empty group), within G1_BOUND of the plain
    output's largest element; then timed at the prefill's w_gate shape
    beside the plain version, ``torch._grouped_mm`` in fp32 (the library
    call; it copies the offsets to the host) and the bound."""
    import torch

    from repro_torch.kernels.grouped_mm import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    err = 0.0
    for m, k, n, ends in G1_CASES:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((len(ends), k, n), generator=gen, device="cuda")
        d = torch.randn((m, n), generator=gen, device="cuda")
        e = torch.tensor(ends, dtype=torch.int32, device="cuda")
        reset_launches()
        got = [ops.grouped_mm_cuda(a, b, e),
               ops.grouped_mm_cuda(d, b.transpose(1, 2), e),
               ops.grouped_mm_wgrad_cuda(a, d, e)]
        torch.cuda.synchronize()
        if launches()["grouped_mm"] != 3:
            raise AssertionError(f"G1 check: launches {launches()}")
        lo = (0,) + ends[:-1]
        want = [ref.grouped_mm_ref(a, b, e),
                ref.grouped_mm_ref(d, b.transpose(1, 2), e),
                torch.stack([a[i:j].T @ d[i:j] for i, j in zip(lo, ends)])]
        for what, x, y in zip(("forward", "input grad", "weight grad"), got,
                              want):
            rel = float((x - y).abs().max() / y.abs().max())
            err = max(err, float((x - y).abs().max()))
            log(f"G1 check: grouped_mm {what}, {m} rows, K {k}, N {n}, "
                f"ends {ends}: max |kernel - plain| / max |plain| "
                f"{rel:.2e} (bound {G1_BOUND:.0e})")
            if not rel <= G1_BOUND:
                raise AssertionError(f"G1 check {what}: {rel}")
        for g, (i, j) in enumerate(zip(lo, ends)):
            if i == j and bool(got[2][g].any()):
                raise AssertionError(f"G1 check: empty group {g}'s gradient")
    m, k, n, ends = G1_CASES[1]
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((len(ends), k, n), generator=gen, device="cuda")
    e = torch.tensor(ends, dtype=torch.int32, device="cuda")
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    k_ms = cuda_ms(lambda: ops.grouped_mm_cuda(a, b, e), 50, flush=flush)
    p_ms = cuda_ms(lambda: ref.grouped_mm_ref(a, b, e), 50, flush=flush)
    lib_ms = cuda_ms(lambda: torch._grouped_mm(a, b, offs=e), 50,
                     flush=flush)
    nbytes = 4 * (m * k + len(ends) * k * n + m * n) + 4 * len(ends)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * m * k * n / FP32_FLOPS_PER_S * 1e3
    bound = max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    log(f"G1 timed at {m} rows, K {k}, N {n}, {len(ends)} groups (fp32, L2 "
        f"flushed, CUDA events): kernel {k_ms:.4f} ms, plain {p_ms:.4f}, "
        f"torch._grouped_mm {lib_ms:.4f}; bound {bound:.5f} ms "
        f"({bound_by}: {nbytes / 1e6:.2f} MB, {2 * m * k * n / 1e6:.1f} "
        f"MFLOP)")
    result["g1"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                        bound_by=bound_by, library_ms=lib_ms,
                        max_abs_err=err)
    del flush


def _moe_small_checks(result) -> None:
    """Phase 40's MoE part: the reduced qwen2-moe and deepseek (gshard)
    federated round on the card against the CPU (B1), and the ragged
    block against gshard at capacity factor 8 on the card (G1 in the
    ragged one's three products)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    for arch in ("qwen2-moe-a2.7b", "deepseek-v3-671b"):
        err, counts, steps = _card_vs_cpu_fed_round(arch, 32)
        log(f"moe check: 2-layer fp32 {arch} (gshard), one SCAFFOLD "
            f"federated_round on the card (B1) vs the CPU: max leaf err "
            f"{err:.2e} (bound 1e-4; relative, c and c_i with a floor of 16 "
            f"eps x over K eta_l); card launches {counts['cuda']}")
        _want_only(f"moe check {arch}", counts["cuda"],
                   scaffold_update=steps)
        if not err <= 1e-4 or any(counts["cpu"].values()):
            raise AssertionError(f"moe check {arch}: {err}, {counts}")
        result.setdefault("b1_paths", {})[f"{arch} card vs CPU"] = steps
        cfg = get_reduced(arch)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        pre = next(k for k in params if k.endswith("/moe/router"))[:-6]
        p = {k[len(pre):]: v[0].cuda() for k, v in params.items()
             if k.startswith(pre)}
        x = torch.randn((2, 32, cfg.d_model),
                        generator=torch.Generator().manual_seed(3)).cuda()
        reset_launches()
        with torch.no_grad():
            out_r, aux_r = L.moe_block_ragged(cfg, p, x)
            out_g, aux_g = L.moe_block_gshard(cfg, p, x, capacity_factor=8.0)
        torch.cuda.synchronize()
        _want_only(f"moe check {arch} blocks", launches(), grouped_mm=3)
        result.setdefault("g1_paths", {})[f"{arch} ragged block"] = 3
        over = float(((out_r - out_g).abs() - MOE_ATOL
                      - MOE_RTOL * out_g.abs()).max())
        aux_rel = abs(float(aux_r) - float(aux_g)) / abs(float(aux_g))
        log(f"moe check: {arch} ragged vs gshard at capacity factor 8 on the "
            f"card: max |diff| {float((out_r - out_g).abs().max()):.2e} "
            f"(bound {MOE_ATOL:.0e} + {MOE_RTOL:.0e} |gshard|: "
            f"{'within' if over <= 0 else 'over'}), aux rel {aux_rel:.2e} "
            f"(bound 1e-5)")
        if over > 0 or not aux_rel <= 1e-5:
            raise AssertionError(f"moe check {arch}: ragged vs gshard")


def _merged_moe_decode(tag, cfg, params) -> None:
    """A trained bf16 MoE model's prefill against ``decode_step`` at
    MOE_CHECK_TOKENS tokens (``_moe_prefill_vs_decode``: routing pinned
    to the prefill's, every position within BF16_DECODE_BOUND), no host
    sync, no kernel of the port (the grouped products are bf16
    ``torch._grouped_mm``)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    pre, dec, _, cache = _moe_prefill_vs_decode(
        f"{tag} ({cfg.num_layers} layers, bf16)", cfg, params,
        MOE_CHECK_TOKENS, BF16_DECODE_BOUND)
    _want_only(f"{tag} prefill", pre)
    _want_only(f"{tag} decode", dec)
    log(f"{tag}: cache leaves {len(cache)}; peak device memory "
        f"{_peak_gb():.2f} GB")
    del cache
    torch.cuda.empty_cache()


def phase_qwen_lora(result):
    """Phase 46, LoRA: qwen2-moe-a2.7b at its published widths, bf16,
    seq 2048, through ``repro_torch.launch.train.main``: LoRA r 8 on the
    default targets (attention, the shared experts and the routed
    experts' 4-D adapters, A (L, 60, 2048, 8) and B (L, 60, 8, 1408)) at
    the depth ``_lm_plan`` admits, logged as a cut; B1 on the fp32 delta
    tree, launches exact. The trained model, merged, is kept for phase
    47."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    seq_len, rounds, steps = 2048, 2, 2 * 2
    base = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                               loss_chunk_vocab=QWEN_CHUNK)
    depth = base.num_layers
    while True:
        cfg = dataclasses.replace(base, num_layers=depth)
        n_t, n_delta, big = _lora_sizes(cfg, LORA_RANK)
        plan = _lm_plan(cfg, seq_len, 1, subset=(n_t, 4 * n_delta, big))[2]
        if plan <= LM_MEMORY_LIMIT or depth == 1:
            break
        depth -= 1
    mo = cfg.moe
    log(f"lora qwen2-moe: {cfg.name} widths (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, {mo.num_experts} experts "
        f"of {mo.expert_d_ff}, top {mo.top_k}, {mo.num_shared_experts} "
        f"shared, vocab {cfg.vocab_size}, {cfg.param_dtype}, ragged "
        f"dispatch); LoRA r {LORA_RANK} targets hold {n_t} params, the "
        f"delta tree {n_delta} elements, the largest target "
        f"{big / 1e9:.2f} GB; memory reckoning at {depth} layers "
        f"{plan / 1e9:.1f} GB (limit {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
    if depth != base.num_layers:
        log(f"reduced: num_layers {base.num_layers} -> {depth} "
            f"(qwen2-moe-a2.7b LoRA, by the memory plan)")
    reset_launches()
    with _depth_cut(depth), _RoundLog("lora qwen2-moe", steps * seq_len,
                                      plan) as rl:
        tr = train.main(_train_argv("qwen2-moe-a2.7b", seq_len, rounds,
                                    QWEN_CHUNK, "--update-space", "lora",
                                    "--lora-rank", str(LORA_RANK)))
    counts = launches()
    _check_subset_rounds("lora qwen2-moe", tr, rl.rows, "lora", n_delta, 4)
    a = tr.x["layers.0.moe.w_gate/A"]
    b = tr.x["layers.0.moe.w_down/B"]
    log(f"lora qwen2-moe: {len(tr.x)} delta leaves; expert adapters "
        f"w_gate/A {tuple(a.shape)}, w_down/B {tuple(b.shape)}; s/round "
        + ", ".join(f"{r['seconds']:.3f}" for r in rl.rows))
    if (tuple(a.shape) != (depth, 60, 2048, LORA_RANK)
            or tuple(b.shape) != (depth, 60, LORA_RANK, 2048)):
        raise AssertionError(f"lora qwen2-moe: adapters {a.shape} {b.shape}")
    n = _want_b1("lora qwen2-moe", counts, tr.spec, 1, rounds)
    result.setdefault("b1_paths", {})["lora qwen2-moe-a2.7b"] = n
    result["qwen_lora"] = (cfg, tr.eval_params())
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_qwen_serve(result):
    """Phase 47: ``repro_torch.launch.serve.main --arch qwen2-moe-a2.7b
    --preset full --batch 8 --prompt-len 128 --max-new 64`` at all 24
    layers (the ragged dispatch through ``torch._grouped_mm``, bf16),
    ``generate`` under ``_no_host_sync``: ms a step, new tokens/s, peak
    memory; then phase 46's LoRA model, merged (``_merged_moe_decode``):
    its prefill against ``decode_step`` at MOE_CHECK_TOKENS tokens, the
    decode's routing pinned to the prefill's."""
    import torch

    from repro_torch.launch import serve

    reset_launches()
    with _guarded_generate():
        served = serve.main(list(QWEN_SERVE_ARGS))
    _want_only("serve qwen2-moe", launches())
    tok = served.tokens
    log(f"serve qwen2-moe-a2.7b (24 layers, bf16): {served.steps} steps, "
        f"{served.ms_per_step:.2f} ms a step, "
        f"{tok.numel() / served.seconds:.1f} new tokens/s, peak device "
        f"memory {served.peak_bytes / 1e9:.2f} GB")
    if tok.shape != (8, 64) or int(tok.min()) < 0 or \
            int(tok.max()) >= 151936:
        raise AssertionError(f"serve qwen2-moe: tokens {tok.shape}")
    del served, tok
    torch.cuda.empty_cache()
    cfg, params = result.pop("qwen_lora")
    _merged_moe_decode("qwen2-moe LoRA merged", cfg, params)


def phase_qwen_full(result):
    """Phase 46, the full space: qwen2-moe-a2.7b through the trainer at
    the depth ``_lm_plan`` admits at seq 2048, logged as a cut; B1 on the
    one bf16 group, launches exact; a profiled round (busy share); B1
    held to its plain version and timed on the trained tree."""
    import torch

    seq_len, rounds = 2048, 2
    spec = _lm_spec()
    cut, _, _ = _lm_fit(spec, seq_len, arch="qwen2-moe-a2.7b",
                        chunk=QWEN_CHUNK)
    plan = _lm_plan(cut, seq_len, spec.local_batch)[2]
    tr, counts, secs, peaks = _lm_rounds("qwen2-moe", cut, spec, seq_len,
                                         rounds, plan)
    groups = len(_b1_groups(tr))
    n = _want_b1("qwen2-moe", counts, spec, groups, rounds)
    _plan_vs_peak(f"qwen2-moe at {cut.num_layers} layers", plan, max(peaks))
    log(f"qwen2-moe: rounds 2-{rounds} mean {statistics.mean(secs[1:]):.3f} "
        f"s at {cut.num_layers} of 24 layers")
    if groups != 1 or n != 8:
        raise AssertionError(f"qwen2-moe: {groups} groups, B1 {n}")
    result.setdefault("b1_paths", {})["qwen2-moe-a2.7b"] = n
    _profile_round(tr, "qwen2-moe", kernels=("scaffold_update",))
    torch.cuda.empty_cache()
    result["b1"].setdefault("trees", {})[
        f"qwen2-moe {cut.num_layers} layers"] = _time_update_tree(
            f"scaffold_update at the qwen2-moe-a2.7b tree ({cut.num_layers} "
            f"layers, experts stacked)", tr.x, tr.c, spec.eta_l)
    tr.close()
    del tr
    torch.cuda.empty_cache()


def phase_deepseek(result):
    """Phase 48: deepseek-v3-671b at its published widths cut to
    ``DEEPSEEK_LAYERS`` (its 3 dense layers of d_ff 18432 and one MoE
    layer of 256 experts, top 8, and a shared expert; MLA in all), bf16,
    through ``repro_torch.launch.train.main``: LoRA r 8 on
    ``DEEPSEEK_TARGETS`` (the routed experts left out, logged as a cut)
    at the longest of ``DEEPSEEK_SEQS`` whose plan fits; B1 on the delta
    tree, launches exact. Then the trained model's MLA + MoE decode
    against its prefill at MOE_CHECK_TOKENS tokens
    (``_merged_moe_decode``), no host sync."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS,
                              loss_chunk_vocab=DEEPSEEK_CHUNK)
    n_t, n_delta, big = _lora_sizes(cfg, LORA_RANK, DEEPSEEK_TARGETS)
    for seq_len in DEEPSEEK_SEQS:
        n, tree, plan = _lm_plan(cfg, seq_len, 1,
                                 subset=(n_t, 4 * n_delta, big))
        log(f"deepseek: LoRA plan at seq {seq_len}, {DEEPSEEK_LAYERS} "
            f"layers: {plan / 1e9:.1f} GB (limit "
            f"{LM_MEMORY_LIMIT / 1e9:.0f} GB)")
        if plan <= LM_MEMORY_LIMIT:
            break
    mo = cfg.moe
    log(f"deepseek: {n} params ({tree / 1e9:.2f} GB frozen, bf16): "
        f"{mo.first_dense_layers} dense layers of d_ff {mo.dense_d_ff}, "
        f"{_moe_layers(cfg)} MoE layer of {mo.num_experts} experts of "
        f"{mo.expert_d_ff}, top {mo.top_k}, {mo.num_shared_experts} shared;"
        f" MLA ranks {cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}; LoRA r "
        f"{LORA_RANK} on {DEEPSEEK_TARGETS!r}: {n_t} target params, "
        f"{n_delta} delta elements")
    log(f"reduced: num_layers {full.num_layers} -> {DEEPSEEK_LAYERS} "
        f"(deepseek-v3-671b: 3 dense + 1 MoE layer on one card)")
    log(f"reduced: LoRA targets {DEEPSEEK_TARGETS!r} (deepseek-v3-671b: the "
        f"routed experts not targeted)")
    if seq_len != DEEPSEEK_SEQS[0]:
        log(f"reduced: seq {DEEPSEEK_SEQS[0]} -> {seq_len} "
            f"(deepseek-v3-671b)")
    rounds, steps = 2, 2 * 2
    reset_launches()
    with _depth_cut(DEEPSEEK_LAYERS), _RoundLog(
            "lora deepseek", steps * seq_len, plan) as rl:
        tr = train.main(_train_argv("deepseek-v3-671b", seq_len, rounds,
                                    DEEPSEEK_CHUNK, "--update-space", "lora",
                                    "--lora-rank", str(LORA_RANK),
                                    "--lora-targets", DEEPSEEK_TARGETS))
    counts = launches()
    _check_subset_rounds("lora deepseek", tr, rl.rows, "lora", n_delta, 4)
    leaves = sorted({k.rsplit("/", 1)[0] for k in tr.x})
    log(f"lora deepseek: {len(tr.x)} delta leaves on {leaves}")
    if any(".moe.w_" in k for k in leaves) or not any(
            ".moe.shared." in k for k in leaves):
        raise AssertionError(f"lora deepseek: targets {leaves}")
    n = _want_b1("lora deepseek", counts, tr.spec, 1, rounds)
    result.setdefault("b1_paths", {})["lora deepseek-v3-671b"] = n
    served = tr.eval_params()
    tr.close()
    del tr
    torch.cuda.empty_cache()
    _merged_moe_decode("deepseek served (MLA + MoE)", cfg, served)


CENSUS_MEMORY_BOUND = 0.10  # census peak against max_memory_allocated
H100_BF16_FLOPS = 989e12  # dense bf16 (NVIDIA H100 SXM5 data sheet)


def _census_fit(cfg, shape, spec):
    """Cut local_batch, then S, to the largest the census puts within
    ``LM_MEMORY_LIMIT`` (the peak read off one client's one step: every
    step of a round holds the same, and S does not move it, the c_i rows
    lying on the host). A step's peak is affine in local_batch, so the
    census at the spec's b and at 1 name the candidate, which the census
    then confirms (and steps down from while it does not fit). Returns
    ``(spec, shape)`` of the cut and logs each cut ``reduced:``."""
    from repro_torch.launch import dryrun as D

    def peak(sp):
        one = dataclasses.replace(sp, num_sampled=1, local_steps=1,
                                  num_clients=2)
        sh = dataclasses.replace(shape, global_batch=sp.local_batch)
        t0 = time.perf_counter()
        c = D.step_census(cfg, sh, one, device="cuda")
        log(f"dryrun census: {cfg.name} seq {shape.seq_len} local_batch "
            f"{sp.local_batch}: one step's peak {c.peak_bytes / 1e9:.2f} GB"
            f" ({time.perf_counter() - t0:.1f} s)")
        return c.peak_bytes

    base = spec
    seen = {spec.local_batch: peak(spec)}
    if seen[spec.local_batch] > LM_MEMORY_LIMIT and spec.local_batch > 1:
        b_top = spec.local_batch
        seen[1] = peak(dataclasses.replace(spec, local_batch=1))
        per_b = (seen[b_top] - seen[1]) / (b_top - 1)
        fit = [b for b in range(1, b_top)
               if seen[1] + (b - 1) * per_b <= LM_MEMORY_LIMIT]
        spec = dataclasses.replace(spec, local_batch=max(fit or [1]))
        while spec.local_batch > 1:
            if spec.local_batch not in seen:
                seen[spec.local_batch] = peak(spec)
            if seen[spec.local_batch] <= LM_MEMORY_LIMIT:
                break
            spec = dataclasses.replace(spec, local_batch=spec.local_batch - 1)
    if seen.get(spec.local_batch, 0) > LM_MEMORY_LIMIT:
        raise AssertionError(f"dryrun: {cfg.name} does not fit at b "
                             f"{spec.local_batch} (S does not move a "
                             f"step's peak)")
    for what in ("local_batch", "num_sampled"):
        if getattr(spec, what) != getattr(base, what):
            log(f"reduced: {cfg.name} {shape.name} {what} "
                f"{getattr(base, what)} -> {getattr(spec, what)} (the "
                f"census's peak within {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
    return spec, dataclasses.replace(
        shape, global_batch=spec.num_sampled * spec.local_steps
        * spec.local_batch)


CENSUS_OTHERS = ("llama3.2-3b", "qwen2-moe-a2.7b")  # phase 49's census only


def census_job(out_dir: str) -> None:
    """Phase 49's censuses (no allocation; the census is host-bound, 25-80
    s a round census on the card's machine), run in a process of their
    own beside the earlier phases: gemma3-1b x train_4k's cut
    (``_census_fit``), its round's census at the cut and decode_32k's,
    written to ``<out_dir>/gemma3-1b.json``; then the census-only pair
    through the dry run's entry point (``launch.dryrun.main``)."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as D

    # yield the host to the phases beside it: one thread, lowest priority
    os.nice(19)
    torch.set_num_threads(1)
    out = Path(out_dir)
    cfg = D.make_config("gemma3-1b")
    spec, shape = _census_fit(cfg, SHAPES["train_4k"],
                              D.make_round_spec("gemma3-1b",
                                                SHAPES["train_4k"]))
    res = {"spec": {k: getattr(spec, k) for k in
                    ("num_sampled", "local_steps", "local_batch")},
           "global_batch": shape.global_batch}
    for name, sh, sp in (("train", shape, spec),
                         ("decode", SHAPES["decode_32k"], None)):
        t0 = time.perf_counter()
        res[name] = dataclasses.asdict(D.step_census(cfg, sh, sp,
                                                     device="cuda"))
        res[name]["seconds"] = time.perf_counter() - t0
    (out / "gemma3-1b.json").write_text(json.dumps(res))
    for other in CENSUS_OTHERS:
        D.main(["--arch", other, "--shape", "train_4k", "--out-dir",
                str(out)])


def start_census_job():
    """Start ``census_job`` in a process of its own (its output in
    ``OUT/dryrun/job.txt``); phase 49 waits for it."""
    out_dir = OUT / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]; import chip_smoke; "
            f"chip_smoke.census_job({str(out_dir)!r})")
    with open(out_dir / "job.txt", "w") as f:
        return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT)


def _census_vs_card(tag, cen, peak, counts, plan=None):
    """Hold a step's measured peak and launches to its census."""
    err = (cen.peak_bytes - peak) / peak
    beside = (f"; _lm_plan {plan / 1e9:.2f} GB ({(plan - peak) / peak:+.1%})"
              if plan is not None else "")
    log(f"{tag}: census peak {cen.peak_bytes / 1e9:.2f} GB against "
        f"max_memory_allocated {peak / 1e9:.2f} GB ({err:+.1%}, bound "
        f"{CENSUS_MEMORY_BOUND:.0%}){beside}")
    want = {k: cen.kernel_launches.get(k, 0) for k in counts}
    log(f"{tag}: launches {counts}; the census counted "
        f"{cen.kernel_launches}")
    if set(cen.kernel_launches) - set(counts) or counts != want:
        raise AssertionError(f"{tag}: launches {counts} != the census's "
                             f"{cen.kernel_launches}")
    if abs(err) > CENSUS_MEMORY_BOUND:
        raise AssertionError(f"{tag}: census peak {cen.peak_bytes} vs "
                             f"measured {peak}: {err:+.1%}")


def phase_dryrun(result, job):
    """Phase 49: the dry-run census against the card (the docstring's
    49): the censuses of ``census_job`` (started after phase 2), then
    gemma3-1b x train_4k at the census's cut and x decode_32k run for
    real and held to them; the census-only pair logged."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch import census as C
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M

    out_dir = OUT / "dryrun"
    try:
        rc = job.wait(timeout=900)
    finally:
        job.kill()
    for line in (out_dir / "job.txt").read_text().splitlines():
        if line.startswith(("dryrun census", "reduced:")):
            log(line)
    if rc:
        raise AssertionError(f"dryrun: the census job exited {rc}: "
                             f"{(out_dir / 'job.txt').read_text()[-2000:]}")
    job = json.loads((out_dir / "gemma3-1b.json").read_text())
    secs = {k: job[k].pop("seconds") for k in ("train", "decode")}
    arch = "gemma3-1b"
    cfg = D.make_config(arch)
    spec = dataclasses.replace(D.make_round_spec(arch, SHAPES["train_4k"]),
                               **job["spec"])
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=job["global_batch"])
    cen = C.Census(**job["train"])
    log(f"dryrun census: {arch} train_4k S {spec.num_sampled} K "
        f"{spec.local_steps} b {spec.local_batch}: peak "
        f"{cen.peak_bytes / 1e9:.2f} GB, {cen.flops / 1e12:.1f} TFLOP, "
        f"{cen.bytes / 1e12:.1f} TB unfused, {cen.ops} ops, launches "
        f"{cen.kernel_launches} ({secs['train']:.1f} s)")
    plan = _lm_plan(cfg, shape.seq_len, spec.local_batch)[2]

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(49)
    x = M.init_params(cfg, gen)
    c = {k: torch.zeros_like(v) for k, v in x.items()}
    c_i = {k: torch.zeros((spec.num_sampled,) + tuple(v.shape),
                          dtype=v.dtype) for k, v in x.items()}  # host
    lead = (spec.num_sampled, spec.local_steps, spec.local_batch,
            shape.seq_len)
    batch = {k: torch.randint(0, cfg.vocab_size, lead, generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    x_new, _, _, metrics = D.train_step(cfg, spec)(x, c, c_i, batch)
    torch.cuda.synchronize()
    secs_round = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    bad = [k for k, v in x_new.items() if not bool(torch.isfinite(v).all())]
    if not math.isfinite(loss) or bad:
        raise AssertionError(f"dryrun {arch} train_4k: loss {loss}, "
                             f"non-finite leaves {bad}")
    tag = f"dryrun {arch} train_4k"
    _census_vs_card(tag, cen, peak, counts, plan)
    share = cen.flops / secs_round / H100_BF16_FLOPS
    log(f"{tag}: round {secs_round:.2f} s, loss {loss:.4f}; census "
        f"{cen.flops / 1e12:.1f} TFLOP over it = {share:.1%} of "
        f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    if not 0 < share <= 1:
        raise AssertionError(f"{tag}: flop share {share}")
    result.setdefault("b1_paths", {})[tag] = counts["scaffold_update"]
    result.setdefault("b5_paths", {})[tag] = counts["swa_attention"]
    del x, c, c_i, batch, x_new, metrics
    torch.cuda.empty_cache()

    shape = SHAPES["decode_32k"]
    cen = C.Census(**job["decode"])
    log(f"dryrun census: {arch} decode_32k: peak "
        f"{cen.peak_bytes / 1e9:.2f} GB, {cen.flops / 1e9:.1f} GFLOP, "
        f"launches {cen.kernel_launches} ({secs['decode']:.1f} s)")
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, gen)
    b = shape.global_batch
    cache = M.init_cache(cfg, b, shape.seq_len)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.randint(0, shape.seq_len, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = M.decode_step(cfg, params, cache, tokens, pos)
    torch.cuda.synchronize()
    secs_step = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() - base
    if (tuple(logits.shape) != (b, 1, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"dryrun {arch} decode_32k: logits "
                             f"{tuple(logits.shape)}")
    _census_vs_card(f"dryrun {arch} decode_32k", cen, peak, counts)
    log(f"dryrun {arch} decode_32k: one step {secs_step * 1e3:.1f} ms (the "
        f"first, cold); census {cen.flops / 1e9:.1f} GFLOP")
    del params, cache, tokens, pos, logits
    torch.cuda.empty_cache()

    for other in CENSUS_OTHERS:
        o = json.loads((out_dir / f"{other}__train_4k__1x1.json").read_text())
        mem, cost = o["memory"], o["cost_struct"]
        log(f"dryrun census: {other} train_4k S "
            f"{o['round_spec']['num_sampled']} K "
            f"{o['round_spec']['local_steps']} b "
            f"{o['round_spec']['local_batch']} (launch.dryrun.main, device "
            f"{o['device']}): peak {mem['peak_bytes'] / 1e9:.2f} GB (fits 80 "
            f"GB: {mem['fits_80gb']}), {cost['flops'] / 1e12:.1f} TFLOP, "
            f"launches {cost['kernel_launches']}, no allocation "
            f"({o['lower_s']:.1f} s)")


CENSUS_JOB: list = []  # the census job's process while it runs


def _phase(fn, *args):
    """Run one phase and log its seconds (host clock, the card
    synchronised after it), and, while the census job runs, that the
    phase overlapped it."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    beside = ""
    if CENSUS_JOB:
        beside = " (beside the census job)"
        if CENSUS_JOB[0].poll() is not None:
            beside = " (the census job ended during it)"
            CENSUS_JOB.clear()
    log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s{beside}")
    return out


def main() -> int:
    """Run every phase; 0 when all passed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_all = time.perf_counter()
    smi = _phase(phase_environment)
    (OUT / "ptxas.txt").unlink(missing_ok=True)
    pending = _phase(phase_build)
    _phase(phase_b1_plain)
    _phase(phase_b2_plain)
    result = {}
    _phase(phase_b5_plain, result)
    _phase(phase_lm_small)
    _phase(phase_gemma_small)
    _phase(phase_gemma_full, result)
    _phase(phase_lm_full, result)
    _phase(phase_lm_momentum, result)
    _phase(phase_build_wait, pending)
    census = start_census_job()  # phase 49's censuses, host-bound
    atexit.register(census.kill)
    CENSUS_JOB.append(census)
    _phase(phase_b3_plain)
    _phase(phase_b4_plain)
    from repro_torch.data import make_similarity_quadratics

    t0 = time.perf_counter()
    ds = make_similarity_quadratics(20, 1024, delta=0.3, G=8.0, mu=0.3)
    log(f"quad: 20 clients, d=1024 built in {time.perf_counter() - t0:.1f} s")
    _phase(phase_quadratics, ds, result)
    _phase(phase_quad_heavy_ball, ds, result)
    _phase(phase_quad_sched_adam, ds, result)
    _phase(phase_emnist_table5, result)
    _phase(phase_emnist_codecs, result)
    _phase(phase_lora_llama, result)
    _phase(phase_lora_gemma, result)
    _phase(phase_head_only_gemma, result)
    _phase(phase_spaces_small, result)
    _phase(phase_fig3_scanned, result)
    _phase(phase_table5_scanned, result)
    _phase(phase_capture_checks, result)
    _phase(phase_gemma_scanned, result)
    _phase(phase_tiered_emnist, result)
    _phase(phase_population, result)
    _phase(phase_pipelined, result)
    _phase(phase_async_degenerate, ds, result)
    del ds
    _phase(phase_async_stragglers, result)
    _phase(phase_async_gemma, result)
    _phase(phase_ssm_small)
    _phase(phase_hymba_full, result)
    _phase(phase_mamba2_full, result)
    _phase(phase_new_small, result)
    _phase(phase_minitron_full, result)
    _phase(phase_paligemma_full, result)
    _phase(phase_gemma_long, result)
    _phase(phase_whisper_full, result)
    _phase(phase_decode_small, result)
    _phase(phase_gemma_serve, result)
    _phase(phase_serve_full, result)
    _phase(phase_serve_checkpoint, result)
    _phase(phase_encdec_serve, result)
    _phase(phase_minicpm3, result)
    _phase(phase_qwen_lora, result)
    _phase(phase_qwen_serve, result)
    _phase(phase_qwen_full, result)
    _phase(phase_deepseek, result)
    _phase(phase_dryrun, result, census)
    log(f"the profiler's own processing: "
        f"{sum(PROFILER_SECONDS.values()):.1f} s in all (" + ", ".join(
            f"{k} {v:.1f}" for k, v in PROFILER_SECONDS.items()) + ")")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    # B1-B4 are bound by bytes and no one PyTorch call computes them
    for key in ("b1", "b2", "b3", "b4", "b5", "g1"):
        paths = result.pop(f"{key}_paths")
        result[f"{key}_launches"] = sum(paths.values())
        result[key]["launches_by_path"] = paths
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[src], replaces=where,
             launches=result[f"{key}_launches"],
             **{"bound_by": "bytes", "library_ms": None, **result[key]})
        for name, src, where, key in (
            ("scaffold_update", "update", B1_REPLACES, "b1"),
            ("scaffold_momentum_update", "update", B2_REPLACES, "b2"),
            ("scaffold_local_loop", "loop", B3_REPLACES, "b3"),
            ("scaffold_momentum_local_loop", "loop", B4_REPLACES, "b4"),
            ("swa_attention", "swa", B5_REPLACES, "b5"),
            ("grouped_mm", "grouped", G1_REPLACES, "g1"))]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
