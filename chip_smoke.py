#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. environment: card name and power limit, torch/CUDA versions, TF32 off
  2. build: both CUDA kernels from src/repro_torch/kernels/**/csrc into
     build/kernels/, the nvcc processes started together
  3. the fused corrected-step kernel (B1) against its plain version
  4. the K-step local-loop kernel (B3) against its plain version
  5. a 2-layer fp32 llama, one SCAFFOLD round on the card vs the CPU
  6. the LM slice: llama3.2-3b widths in bf16, SCAFFOLD through the fused
     update kernel, with its launch count, kernel timing, memory and a
     profiled round
  7. the quadratics slice: the K-step kernel path and the per-step fused
     path, launch counts and agreement

It prints the ``kernels`` JSON line, the card's name and power limit, and
last the ``{"ok": true, "device": ...}`` line. It imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
LM_MEMORY_LIMIT = 72e9     # bytes the LM phase may plan to hold on the card
B1_REPLACES = "src/repro/kernels/scaffold_update/kernel.py:46"
B3_REPLACES = "src/repro/kernels/scaffold_update/megakernel.py:108"


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


def ulp_distance(a, b):
    """Max distance in units of the last place between two like tensors
    of one float dtype (fp32 or bf16)."""
    import torch

    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    ia = a.contiguous().view(ity).long()
    ib = b.contiguous().view(ity).long()
    bits = 31 if a.dtype == torch.float32 else 15
    # map the sign-magnitude encoding onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & ((1 << bits) - 1)), ia)
    ib = torch.where(ib < 0, -(ib & ((1 << bits) - 1)), ib)
    return int((ia - ib).abs().max())


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


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
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s); allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    """Phase 2: build both kernels, nvcc processes in parallel."""
    from repro_torch.kernels import build

    secs = build.build()
    log(f"build: {sorted(build.SOURCES)} in {secs:.1f} s wall, into "
        f"{build.BUILD_DIR}")
    for name, out in sorted(build.BUILD_LOGS.items()):
        used = [ln.strip() for ln in out.splitlines() if "Used" in ln]
        log(f"  ptxas {name}: {len(used)} kernels, e.g. "
            f"{used[0] if used else 'no ptxas report'}")


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
    launches = ops.LAUNCHES["scaffold_update"] - before
    torch.cuda.synchronize()
    worst = max(ulp_distance(work[k],
                             ref.scaffold_update_ref(y[k], g[k], c[k], eta))
                for k in y)
    log(f"scaffold_update_packed mixed tree, in place: {groups} dtype groups,"
        f" {launches} launches, worst leaf {worst} ulp (bound 1)")
    if launches != groups or worst > 1:
        raise AssertionError("scaffold_update_packed mixed tree failed")


def _b3_inputs(gen, d, K, bsz, ty, tab):
    import torch

    y = torch.randn(d, generator=gen, device="cuda").to(ty)
    corr = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(ty)
    A = (torch.randn((K, bsz, d, d), generator=gen, device="cuda")
         / math.sqrt(d)).to(tab)
    b = torch.randn((K, bsz, d), generator=gen, device="cuda").to(tab)
    eta = torch.linspace(0.1, 0.05, K, device="cuda")
    return y, corr, eta, A, b


def phase_b3_plain():
    """Phase 4: the K-step loop kernel against its plain version."""
    import torch

    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    lines = []
    for ty in (f32, bf16):
        for tab in (f32, bf16):
            worst_y = worst_l = 0.0
            for d in (20, 1000, 1024):
                for K in (1, 10):
                    for bsz in (1, 2):
                        y, corr, eta, A, b = _b3_inputs(gen, d, K, bsz, ty,
                                                        tab)
                        yk, lk = mk.scaffold_local_loop_cuda(y, corr, eta,
                                                             A, b)
                        yp, _, lp = ref.scaffold_local_loop_ref(y, corr, eta,
                                                                A, b)
                        torch.cuda.synchronize()
                        # fp32 y: summation order only. bf16 y is rounded
                        # to bf16 every step from fp32 values that differ
                        # by the summation order (~1e-7 relative), so a
                        # rounding rarely flips; allow 2 bf16 ulps at
                        # max|y|, as a relative error. The losses are fp32.
                        scale = float(yp.float().abs().max())
                        bound = (1e-5 if ty == f32
                                 else 2 * bf16_ulp(scale) / scale)
                        ey, el = rel_err(yk, yp), rel_err(lk, lp)
                        lines.append(f"d={d} K={K} bsz={bsz} y {ty} A,b {tab}:"
                                     f" rel err y_K {ey:.2e} (bound "
                                     f"{bound:.2e}), losses {el:.2e} (bound "
                                     f"1e-5)")
                        if ey > bound or el > 1e-5:
                            raise AssertionError(lines[-1])
                        worst_y, worst_l = max(worst_y, ey), max(worst_l, el)
            log(f"scaffold_local_loop y {ty} A,b {tab}: 12 shapes (d 20/1000/"
                f"1024, K 1/10, bsz 1/2), worst rel err y_K {worst_y:.2e}, "
                f"losses {worst_l:.2e} (bound y_K "
                f"{'1e-5' if ty == f32 else '2 bf16 ulps of max|y|'}, "
                f"losses 1e-5)")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "b3_cases.txt").write_text("\n".join(lines) + "\n")


def phase_lm_small():
    """Phase 5: a 2-layer fp32 llama round, card vs CPU."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    cfg = get_reduced("llama3.2-3b")
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.05,
                        strategy="client_sequential")
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    xs = {}
    for dev in ("cuda", "cpu"):
        tr = FederatedTrainer(partial(M.loss_fn, cfg),
                              lambda gen: {k: v.clone() for k, v in p0.items()},
                              spec, SyntheticLMFederated(4, cfg.vocab_size, 32),
                              seed=0, use_fused_update=True, device=dev)
        tr.run_round()
        xs[dev] = {k: v.cpu() for k, v in tr.x.items()}
    err = max(rel_err(xs["cuda"][k], xs["cpu"][k]) for k in p0)
    log(f"lm check: 2-layer fp32 llama, one SCAFFOLD round on the card (fused "
        f"kernel) vs the CPU (plain): max leaf rel err {err:.2e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"lm check rel err {err}")


def _lm_plan(cfg, seq_len: int, local_batch: int):
    """Reckoned peak device bytes of the LM slice at cfg's depth: the
    param-sized trees resident at once (x, c, the dy and dc sums, the
    client's c_i, c - c_i, its working copy y, and the grads or, after the
    steps, c_i_new and dc: 8), plus activations and temporaries."""
    from repro_torch.models.model import count_params_analytic

    n = count_params_analytic(cfg)
    tree = 2 * n  # bf16
    t = seq_len * local_batch
    e, f = cfg.d_model, cfg.d_ff
    act = cfg.num_layers * (t * (10 * e + 5 * f) * 2
                            + 2 * cfg.num_heads * seq_len ** 2 * 4 * local_batch)
    largest = 2 * cfg.num_layers * e * f
    temps = 2 * 2 * cfg.vocab_size * e + 4 * largest
    return n, tree, 8 * tree + act + temps


def _lm_trainer(cfg, spec, seq_len, **kw):
    import torch

    from repro_torch.core import FederatedTrainer
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    return FederatedTrainer(
        partial(M.loss_fn, cfg),
        lambda gen: M.init_params(cfg, gen, device="cuda"), spec,
        SyntheticLMFederated(spec.num_clients, cfg.vocab_size, seq_len),
        seed=0, use_fused_update=True, device="cuda", **kw)


def _device_time_ms(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    if us is None:
        us = getattr(ev, "self_cuda_time_total", 0.0)
    return us / 1e3


def phase_lm_full(result):
    """Phase 6: the LM slice at llama3.2-3b widths in bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import megakernel_incompatibility
    from repro_torch.kernels.scaffold_update import ops, ref

    seq_len, rounds = 256, 3
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        strategy="client_sequential")
    base = dataclasses.replace(get_config("llama3.2-3b"),
                               loss_chunk_vocab=16032)
    depth = base.num_layers
    while True:
        cfg = dataclasses.replace(base, num_layers=depth)
        n, tree, peak = _lm_plan(cfg, seq_len, spec.local_batch)
        if peak <= LM_MEMORY_LIMIT or depth == 1:
            break
        depth -= 1
    log(f"lm: llama3.2-3b widths (d_model {cfg.d_model}, {cfg.num_heads}q/"
        f"{cfg.num_kv_heads}kv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab"
        f" {cfg.vocab_size}, tied, bf16), CE over vocab chunks of "
        f"{cfg.loss_chunk_vocab}; {n} params, {tree / 1e9:.2f} GB a tree")
    log(f"lm: memory reckoning at num_layers {depth}: 8 param-sized trees "
        f"= {8 * tree / 1e9:.1f} GB + activations and temporaries = "
        f"{peak / 1e9:.1f} GB (limit {LM_MEMORY_LIMIT / 1e9:.0f} GB)")
    if depth != base.num_layers:
        log(f"reduced: num_layers {base.num_layers} -> {depth}")
    t0 = time.perf_counter()
    tr = _lm_trainer(cfg, spec, seq_len)
    torch.cuda.synchronize()
    log(f"lm: trainer set-up {time.perf_counter() - t0:.1f} s (init on the "
        f"card, host store of {tr.store.population_nbytes / 1e9:.1f} GB)")
    groups = len({(v.dtype,) * 3 for v in tr.x.values()})
    tokens = spec.num_sampled * spec.local_steps * spec.local_batch * seq_len

    ops.reset_launches()
    secs = []
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = tr.run_round()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peak_mem = torch.cuda.max_memory_allocated()
        log(f"lm round {r + 1}: loss {m['loss']:.4f}, drift {m['drift']:.4e},"
            f" {secs[-1]:.3f} s, {tokens / secs[-1]:.1f} tokens/s, peak "
            f"device memory {peak_mem / 1e9:.2f} GB")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["drift"])):
            raise AssertionError(f"lm round {r + 1}: non-finite {m}")
    launches = dict(ops.LAUNCHES)
    want = rounds * spec.num_sampled * spec.local_steps * groups
    log(f"lm: scaffold_update launches {launches['scaffold_update']} == rounds"
        f" {rounds} x S {spec.num_sampled} x K {spec.local_steps} x groups "
        f"{groups} = {want}; scaffold_local_loop launches "
        f"{launches['scaffold_local_loop']}")
    if launches["scaffold_update"] != want:
        raise AssertionError(f"lm: B1 launches {launches} != {want}")
    result["b1_launches"] = launches["scaffold_update"]

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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of the kernels they launched
    dev_events = [e for e in avgs if _device_time_ms(e) > 0
                  and "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(_device_time_ms(e) for e in dev_events) / 1e3
    top = sorted(dev_events, key=_device_time_ms, reverse=True)[:8]
    if busy > 0:
        log(f"lm profiled round: wall {wall:.3f} s, device busy {busy:.3f} s "
            f"({100 * busy / wall:.1f}%); device time by kernel: "
            + "; ".join(f"{e.key[:60]} {_device_time_ms(e):.1f} ms "
                        f"x{e.count}" for e in top))
    else:
        log(f"lm profiled round: wall {wall:.3f} s, device busy share not "
            f"measured (the profiler reported no device time)")
    sort_key = ("self_device_time_total" if hasattr(avgs[0],
                "self_device_time_total") else "self_cuda_time_total")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "lm_profile.txt").write_text(avgs.table(sort_by=sort_key,
                                                   row_limit=40))
    del tr, prof, avgs, dev_events, top
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


def phase_quadratics(result):
    """Phase 7: the quadratics slice, K-step kernel vs per-step path."""
    import torch

    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import make_similarity_quadratics, quadratic_loss
    from repro_torch.kernels.scaffold_update import megakernel as mk
    from repro_torch.kernels.scaffold_update import ops, ref

    t0 = time.perf_counter()
    ds = make_similarity_quadratics(20, 1024, delta=0.3, G=8.0, mu=0.3)
    log(f"quad: 20 clients, d=1024 built in {time.perf_counter() - t0:.1f} s")
    spec = FedRoundSpec(algorithm="scaffold", num_clients=20, num_sampled=4,
                        local_steps=10, local_batch=1, eta_l=0.1)
    rounds, xs = 3, {}
    for name, sp, want in (
            ("megakernel", dataclasses.replace(spec, use_megakernel=True),
             (12, 0)),
            ("per_step_fused", spec, (0, 120))):
        tr = FederatedTrainer(quadratic_loss,
                              lambda gen: {"x": torch.ones(ds.dim)}, sp, ds,
                              seed=0, use_fused_update=True, device="cuda")
        subs = [ds.suboptimality(tr.x)]
        ops.reset_launches()
        secs = []
        for _ in range(rounds):
            # only the round is timed; the suboptimality is evaluated on
            # the host after it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.run_round()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            subs.append(ds.suboptimality(tr.x))
            if sp.use_megakernel and m["megakernel_fallback_reason"] != "":
                raise AssertionError(f"quad fallback: {m}")
        got = (ops.LAUNCHES["scaffold_local_loop"],
               ops.LAUNCHES["scaffold_update"])
        log(f"quad {name}: launches (local_loop, scaffold_update) = {got}; "
            f"suboptimality " + " -> ".join(f"{s:.4e}" for s in subs)
            + "; s/round " + ", ".join(f"{s:.4f}" for s in secs)
            + f" (rounds 2-{rounds} mean {statistics.mean(secs[1:]):.4f})")
        if got != want:
            raise AssertionError(f"quad {name}: launches {got} != {want}")
        if name == "megakernel":
            result["b3_launches"] = got[0]
        xs[name] = tr.x["x"].cpu()
    err = rel_err(xs["megakernel"], xs["per_step_fused"])
    log(f"quad: final x, megakernel vs per-step fused path: rel err "
        f"{err:.2e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"quad final x rel err {err}")

    # B3 at d=1024, K=10, bsz=1, in two layouts of A: "fresh", a distinct
    # A per step (the bound of the kernels line: K*d*d*4 bytes), and
    # "broadcast", the trainer's own stride-0 view of one client's A
    # (quadratics.round_batches), which reads 4 MB once and then from L2
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, K = 1024, 10
    y, corr, eta, A, b = _b3_inputs(gen, d, K, 1, torch.float32,
                                    torch.float32)
    view = ds.round_batches(np.array([0]), K, 1, None, device="cuda")
    layouts = {"fresh": (A, b, K * d * d * 4 + K * d * 4),
               "broadcast": (view["A"][0], view["b"][0], d * d * 4 + d * 4)}
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    for name, (A, b, a_bytes) in layouts.items():
        yk, _ = mk.scaffold_local_loop_cuda(y, corr, eta, A, b)
        yp, _, _ = ref.scaffold_local_loop_ref(y, corr, eta, A, b)
        err = float((yk - yp).abs().max())
        # kernel and plain in turns (plain, kernel, kernel, plain, ...),
        # L2 flushed before each call; the median of each side, and its
        # spread across the turns
        k_all, p_all = [], []
        for turn in range(6):
            order = (("plain", "kernel") if turn % 2 == 0
                     else ("kernel", "plain"))
            for side in order:
                if side == "kernel":
                    k_all.append(cuda_ms(lambda: mk.scaffold_local_loop_cuda(
                        y, corr, eta, A, b), 5, flush=flush))
                else:
                    p_all.append(cuda_ms(lambda: ref.scaffold_local_loop_ref(
                        y, corr, eta, A, b), 2, flush=flush))
        k_ms, p_ms = statistics.median(k_all), statistics.median(p_all)
        # bytes: A and b read once, y and corr read, y_K and the losses
        # written
        nbytes = a_bytes + 4 * d * 4 + K * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"scaffold_local_loop d={d} K={K} bsz=1 fp32, A {name}: kernel "
            f"{k_ms:.4f} ms (6 turns, {min(k_all):.4f}-{max(k_all):.4f}), "
            f"plain {p_ms:.4f} ms ({min(p_all):.4f}-{max(p_all):.4f}), bound "
            f"{bound:.4f} ms (bytes, {nbytes / 1e6:.2f} MB, L2 flushed), "
            f"max |y_K kernel - plain| {err:.3e}")
        if name == "fresh":
            result["b3"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                bound_ms=bound)


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
    smi = phase_environment()
    phase_build()
    phase_b1_plain()
    phase_b3_plain()
    phase_lm_small()
    result = {}
    phase_lm_full(result)
    phase_quadratics(result)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    kernels = [
        dict(name="scaffold_update", route="cuda",
             source="src/repro_torch/kernels/scaffold_update/csrc/"
                    "scaffold_update.cu",
             replaces=B1_REPLACES, launches=result["b1_launches"],
             **result["b1"], bound_by="bytes", library_ms=None),
        dict(name="scaffold_local_loop", route="cuda",
             source="src/repro_torch/kernels/scaffold_update/csrc/"
                    "local_loop.cu",
             replaces=B3_REPLACES, launches=result["b3_launches"],
             **result["b3"], bound_by="bytes", library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
