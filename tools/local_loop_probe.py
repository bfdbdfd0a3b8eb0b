#!/usr/bin/env python3
"""Times the port's K-step local-loop kernels (B3, B4) of one checkout on
one CUDA card, by the same method whichever version of the kernel that
checkout holds, so that two versions can be compared in one run:

    python3 tools/local_loop_probe.py [--src DIR] [--tag NAME]

``DIR`` is the ``src`` directory of the checkout to time (default: this
checkout's); its ``repro_torch`` builds its kernels into its own tree.
For B3 and B4 at d 1024, K 10, bsz 1, fp32, in the "broadcast" layout
(one client's A as a stride-0 view over K, as the trainer passes it) and
the "fresh" layout (a distinct A per step), it measures:

- ``card_ms``: the card's time a call (``chip_smoke.card_ms``: CUDA
  events around a call the host queued during a GPU spin, L2 flushed);
- ``per_call_ms``: CUDA events around a call with no spin, L2 flushed
  (``chip_smoke.cuda_ms``): the wrapper's host time shows in it only
  where it outlasts the L2 flush queued before the call;
- ``host_us``: the wrapper's host time a call, median of 30 calls by the
  host clock, the card idle before each.

Where the checkout has the grid design (``megakernel.barrier_floor``) it
also measures, in the broadcast layout, the card time at K 1 and K 20
(the cost of a step and the fixed cost) and K grid barriers alone, with
and without the barriers (the cost of one barrier). It prints one line a
measurement, the card's name and power limit, and last one JSON object of
the numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, K = 1024, 10
TURNS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("local_loop_probe: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.scaffold_update import megakernel as mk

    print(f"{args.tag}: repro_torch from {Path(mk.__file__).resolve()}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    y, corr, eta, A, b = cs._b3_inputs(gen, D, K, 1, torch.float32,
                                       torch.float32)
    m = torch.randn(D, generator=gen, device="cuda")
    A1, b1 = A[:1], b[:1]
    layouts = {"broadcast": (A1.expand(K, 1, D, D), b1.expand(K, 1, D)),
               "fresh": (A, b)}
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = hasattr(mk, "barrier_floor")
    out = {"tag": args.tag, "grid": grid}
    for name, kw in (("B3", {}), ("B4", dict(m=m, beta=0.9))):
        for layout, (Al, bl) in layouts.items():
            def call(Al=Al, bl=bl, kw=kw):
                return mk.scaffold_local_loop_cuda(y, corr, eta, Al, bl, **kw)

            card, per_call = [], []
            for _ in range(TURNS):
                card.append(cs.card_ms(call, 10, flush, 1_000_000))
                per_call.append(cs.cuda_ms(call, 10, flush=flush))
            host = []
            for _ in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            row = dict(card_ms=statistics.median(card),
                       per_call_ms=statistics.median(per_call),
                       host_us=1e6 * statistics.median(host))
            print(f"{args.tag} {name} {layout}: card time {cs.spread(card)};"
                  f" per call {cs.spread(per_call)}; wrapper host time "
                  f"{row['host_us']:.1f} us a call", flush=True)
            out[f"{name}_{layout}"] = row
        if not grid:
            continue
        at_k = {}
        for kk in (1, 20):
            ek = torch.linspace(0.1, 0.05, kk, device="cuda")
            Ak, bk = A1.expand(kk, 1, D, D), b1.expand(kk, 1, D)
            at_k[kk] = statistics.median(cs.card_ms(
                lambda: mk.scaffold_local_loop_cuda(y, corr, ek, Ak, bk, **kw),
                10, flush, 1_000_000) for _ in range(TURNS))
        plan = mk.local_loop_plan(D, K, 0, sms)
        bars = {kk: statistics.median(cs.card_ms(
            lambda: mk.barrier_floor(plan, kk, "cuda"), 10, flush, 1_000_000)
            for _ in range(TURNS)) for kk in (0, K)}
        per_step = (at_k[20] - at_k[1]) / 19
        split = dict(k1_ms=at_k[1], k20_ms=at_k[20], step_us=1e3 * per_step,
                     fixed_us=1e3 * (at_k[1] - per_step),
                     empty_launch_ms=bars[0], barriers_ms=bars[K],
                     barrier_us=1e3 * (bars[K] - bars[0]) / K)
        print(f"{args.tag} {name} broadcast: card time at K 1 "
              f"{at_k[1]:.4f} ms, K 20 {at_k[20]:.4f} ms: "
              f"{split['step_us']:.2f} us a step, {split['fixed_us']:.2f} us "
              f"fixed; {plan.grid} blocks: empty launch {bars[0]:.4f} ms, "
              f"{K} barriers {bars[K]:.4f} ms ({split['barrier_us']:.2f} us "
              f"a barrier)", flush=True)
        out[f"{name}_split"] = split
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
