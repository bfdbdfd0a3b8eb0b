#!/usr/bin/env python3
"""What ``torch._grouped_mm`` does on this machine's card, per dtype:

    python3 tools/grouped_mm_probe.py

For bf16 and fp32 it runs a 2-D x 3-D grouped product (rows of ``a``
split by int32 group ends ``offs``, one of them an empty group) and its
backward under ``torch.cuda.set_sync_debug_mode("error")``, and prints
whether either made a host sync, and how far each result lies from the
per-segment ``@``. Then it times the forward and backward at
qwen2-moe-a2.7b's expert widths (8192 rows, 60 experts, d 2048, f 1408,
bf16). It prints the card's name and power limit, and last one JSON
object of the results. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch


def per_segment(a, b, ends):
    out, lo = [], 0
    for g, hi in enumerate(ends):
        out.append(a[lo:hi] @ b[g])
        lo = hi
    return torch.cat(out)


def check(dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    ends = [16, 16, 40, 64]  # group 1 is empty
    a = torch.randn((64, 256), generator=gen, device="cuda").to(dtype)
    b = torch.randn((4, 256, 128), generator=gen, device="cuda").to(dtype)
    offs = torch.tensor(ends, dtype=torch.int32, device="cuda")
    res = {"dtype": str(dtype).split(".")[-1]}
    a1 = a.clone().requires_grad_(True)
    b1 = b.clone().requires_grad_(True)
    g = torch.randn((64, 128), generator=gen, device="cuda").to(dtype)
    torch.cuda.synchronize()
    for step in ("forward", "backward"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            if step == "forward":
                out = torch._grouped_mm(a1, b1, offs=offs)
            else:
                out.backward(g)
            res[f"{step}_sync"] = False
        except RuntimeError as e:
            res[f"{step}_sync"] = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if step == "forward" and res["forward_sync"]:
            out = torch._grouped_mm(a1, b1, offs=offs)
    if res["backward_sync"]:
        a1.grad = b1.grad = None
        out = torch._grouped_mm(a1, b1, offs=offs)
        out.backward(g)
    a2 = a.float().clone().requires_grad_(True)
    b2 = b.float().clone().requires_grad_(True)
    want = per_segment(a2, b2, ends)
    want.backward(g.float())
    scale = float(want.abs().max())
    res["forward_err"] = float((out.float() - want).abs().max()) / scale
    res["grad_a_err"] = float((a1.grad.float() - a2.grad).abs().max()) / \
        float(a2.grad.abs().max())
    res["grad_b_err"] = float((b1.grad.float() - b2.grad).abs().max()) / \
        float(b2.grad.abs().max())
    res["grad_b_empty_group_max"] = float(b1.grad[1].abs().max())
    return res


def timed(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def width_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, e, d, f = 8192, 60, 2048, 1408
    a = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
    b = (torch.randn((e, d, f), generator=gen, device="cuda") * 0.02
         ).bfloat16().requires_grad_(True)
    sizes = torch.bincount(torch.randint(0, e, (rows,), generator=gen,
                                         device="cuda"), minlength=e)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    a.requires_grad_(True)
    g = torch.randn((rows, f), generator=gen, device="cuda").bfloat16()
    fwd = timed(lambda: torch._grouped_mm(a, b, offs=offs))

    def fwd_bwd():
        torch._grouped_mm(a, b, offs=offs).backward(g)

    both = timed(fwd_bwd)
    flops = 2 * rows * d * f
    return {"rows": rows, "experts": e, "d": d, "f": f, "forward_ms": fwd,
            "forward_backward_ms": both,
            "forward_tflops": flops / fwd / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_mm_probe: needs a CUDA card", file=sys.stderr)
        return 2
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "has_grouped_mm": hasattr(torch, "_grouped_mm")}
    out["checks"] = [check(dt) for dt in (torch.bfloat16, torch.float32)]
    out["widths"] = width_times()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
