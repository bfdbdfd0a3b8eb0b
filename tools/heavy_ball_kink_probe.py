#!/usr/bin/env python3
"""Where one EMNIST MLP round on a CUDA card parts from the same round on
the CPU, and why, for local heavy-ball (B2) and plain local SGD (B1):

    python3 tools/heavy_ball_kink_probe.py

The round is ``chip_smoke.py``'s phase 17 (SCAFFOLD-M, the 784-256-62
MLP, EMNIST-like N 50 at 10 % similarity, S 10, batch 80, eta_l 0.3,
local momentum 0.9), from the same seed-0 weights on both devices. For K
1, 5 and 25 it prints x's largest leaf error, relative to the leaf's
largest |value|, between the card through the kernel, the card through
the plain update, and the CPU. At K 25 it also prints:

- each local step's gradient on the card against the CPU's gradient at
  the same (card) weights and batch: the median and the largest
  relative error, and the steps where a hidden unit's pre-activation
  changes sign between the two devices at equal inputs;
- the hidden units that hold x's elements beyond 1e-4 of their leaf's
  largest |value| after the round (w1's columns, b1's entries, w2's
  rows).

It prints the card's name and power limit, and last one JSON object of
the numbers. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEAVY_BALL = dict(algorithm="scaffold_m", local_solver="momentum",
                  local_momentum=0.9)
SGD = dict(algorithm="scaffold_m")


def rel(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def units_apart(xa, xb, tol):
    """The hidden units holding an element of ``xa`` more than ``tol`` of
    its leaf's largest |value| from ``xb``."""
    units = set()
    for k, red in {"w1": 0, "b1": None, "w2": 1}.items():
        far = (xa[k] - xb[k]).abs() > tol * xb[k].abs().max()
        if red is not None:
            far = far.any(dim=red)
        units.update(far.nonzero()[:, 0].tolist())
    return sorted(units)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("heavy_ball_kink_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer, make_grad_fn
    from repro_torch.data import EmnistLikeFederated
    from repro_torch.models import simple

    data = EmnistLikeFederated(num_clients=50, samples=20_000, seed=0,
                               similarity_pct=10.0)
    lb = data.local_batch_size(0.2)
    init = simple.mlp_init(torch.Generator().manual_seed(0), 784, 62,
                           device="cpu")
    cpu_grad = make_grad_fn(simple.mlp_loss)

    def trainer(dev, fused, K, kw):
        spec = FedRoundSpec(num_clients=50, num_sampled=10, local_steps=K,
                            local_batch=lb, eta_l=0.3, **kw)
        return FederatedTrainer(
            simple.mlp_loss, lambda g: {k: v.clone() for k, v in
                                        init.items()},
            spec, data, seed=0, use_fused_update=fused, device=dev)

    out = {}
    for K in (1, 5, 25):
        for name, kw in (("heavy-ball", HEAVY_BALL), ("sgd", SGD)):
            xs, steps = {}, []
            for tag, dev, fused in (("kernel", "cuda", True),
                                    ("plain", "cuda", False),
                                    ("cpu", "cpu", True)):
                tr = trainer(dev, fused, K, kw)
                if tag == "kernel" and K == 25:
                    inner = tr._grad_fn

                    def recording(params, batch, inner=inner):
                        g, m = inner(params, batch)
                        pc = {k: v.detach().cpu() for k, v in params.items()}
                        bc = {k: v.cpu() for k, v in batch.items()}
                        gc, _ = cpu_grad(pc, bc)
                        h_card = (batch["x"] @ params["w1"]
                                  + params["b1"]).cpu()
                        h_cpu = bc["x"] @ pc["w1"] + pc["b1"]
                        steps.append((
                            max(rel(g[k].cpu(), gc[k]) for k in g),
                            int(((h_card > 0) != (h_cpu > 0)).sum()),
                            float(h_cpu.abs().min())))
                        return g, m

                    tr._grad_fn = recording
                tr.run_round()
                xs[tag] = {k: v.cpu() for k, v in tr.x.items()}
                tr.close()
            row = {
                "kernel_vs_plain": max(rel(xs["kernel"][k], xs["plain"][k])
                                       for k in init),
                "kernel_vs_cpu": max(rel(xs["kernel"][k], xs["cpu"][k])
                                     for k in init),
                "plain_vs_cpu": max(rel(xs["plain"][k], xs["cpu"][k])
                                    for k in init),
                "units_apart": units_apart(xs["kernel"], xs["cpu"], 1e-4)}
            if steps:
                errs = [e for e, _, _ in steps]
                row.update(
                    grad_steps=len(steps),
                    grad_median_rel=statistics.median(errs),
                    grad_max_rel=max(errs),
                    sign_flips=[dict(client=i // K, step=i % K, flips=f,
                                     grad_rel=e, min_abs_h=h)
                                for i, (e, f, h) in enumerate(steps) if f])
            out[f"{name} K {K}"] = row
            print(f"{name} K {K}: " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
