#!/usr/bin/env python3
"""Times the port's fused local-step kernels (B1, B2) of one checkout on
one CUDA card, by the same method whichever version of the kernels that
checkout holds, so that two versions can be compared in one run:

    python3 tools/update_probe.py [--src DIR] [--tag NAME] [--build]

``DIR`` is the ``src`` directory of the checkout to time (default: this
checkout's); its ``repro_torch`` builds its kernels into its own tree.
Trees: the EMNIST MLP (784x256, 256, 256x62, 62; fp32), the quadratics'
one 1024-element fp32 leaf, and gemma3-1b's parameter tree (83 leaves,
999,812,736 bf16, drawn by ``init_params``; no model is built). For B1
(``scaffold_update_packed``) and B2 (``scaffold_momentum_update_packed``,
fp32 slot), both in place as the local solvers call them, it measures:

- ``card_ms``: the card's time a call (``chip_smoke.card_ms``: CUDA
  events around a call the host queued during a GPU spin, L2 flushed);
- ``per_call_ms``: CUDA events around a call with no spin, L2 flushed
  (``chip_smoke.cuda_ms``);
- ``host_us``: the wrapper's host time a call, median of 30 calls by the
  host clock, the card idle before each.

Beside them, by card time: empty kernels of this file's own source (so
the same for every checkout) with a 15,360-byte ``__grid_constant__``
parameter (B1's leaf table before its redesign) and a 512-byte one, on
392 blocks and on 1, and the event pair with nothing between
(``floors``); and ``torch._foreach_add_(ys, gs, alpha=-eta)`` at the MLP
tree, PyTorch's own multi-tensor launch over 3 of B1's 4 tree passes (a
yardstick; it computes less than B1). Where the checkout's wrapper
caches its validation (``ops._groups``) it splits B1's host time at the
MLP tree by part (``host_split_us``). With ``--build`` it first times
``nvcc`` on each of the checkout's CUDA sources, alone and all together
(``build_s``). It prints one line a measurement, the card's name and
power limit, and last one JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURNS = 4
ETA, BETA = 0.3, 0.9
MLP = ((784, 256), (256,), (256, 62), (62,))
QUAD = ((1024,),)
# empty kernels a __grid_constant__ parameter of B bytes, 256 threads a
# block (the launch the redesign started from: 15,360 B on 392 blocks)
FLOOR_CU = r"""
#include <cuda_runtime.h>
template <int B> struct Param { unsigned char b[B]; };
template <int B> __global__ void empty(const __grid_constant__ Param<B> p) {}
extern "C" int launch_empty(int bytes, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bytes == 15360) empty<15360><<<grid, 256, 0, s>>>(Param<15360>{});
  else if (bytes == 512) empty<512><<<grid, 256, 0, s>>>(Param<512>{});
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""
FLOORS = ((15360, 392), (512, 392), (512, 1))


def floor_lib(build):
    """The empty kernels, built with ``nvcc`` into build/update_probe/."""
    out = ROOT / "build" / "update_probe"
    digest = hashlib.sha256(FLOOR_CU.encode()).hexdigest()[:16]
    lib = out / f"libfloor-{digest}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        src = out / f"floor-{digest}.cu"
        src.write_text(FLOOR_CU)
        subprocess.run([build.toolkit(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                       check=True)
    fn = ctypes.CDLL(str(lib)).launch_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def host_split(ops, y, g, c) -> dict:
    """The redesigned wrapper's host time a B1 call at one tree, by part
    (medians of 200 calls, the card idle before each): the device rule,
    the cached validation, the data pointers, and the launch (the ctypes
    call with the current device and stream)."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    roles = (y, g, c, y)
    name = "scaffold_update_packed"
    (grp,), leaves = ops._groups(name, roles, dev)
    ptrs = [t.data_ptr() for t in leaves]
    parts = {
        "resolve_device": lambda: resolve_device("cuda"),
        "validated_groups": lambda: ops._groups(name, roles, dev),
        "data_pointers": lambda: [t.data_ptr() for t in leaves],
        "launch": lambda: ops._launch("scaffold_update", grp, ptrs, ETA, 0.0),
    }
    split = {}
    for part, fn in parts.items():
        times = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        split[part] = 1e6 * statistics.median(times)
    torch.cuda.synchronize()
    return split


def build_seconds(tag: str) -> dict:
    """Wall seconds of ``nvcc`` on each CUDA source of the checkout being
    timed (its ``build.SOURCES`` and ``build.NVCC_FLAGS``): each source
    alone, one after another, then all of them started together as
    ``build.build`` starts them; into build/update_probe/nvcc-<tag>/,
    never into the checkout's library cache."""
    from repro_torch.kernels import build

    out = ROOT / "build" / "update_probe" / f"nvcc-{tag}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.toolkit()

    def start(name, suffix):
        return subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out / f"{name}{suffix}.so"),
             str(build._PKG / build.SOURCES[name])],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    secs = {}
    for name in sorted(build.SOURCES):
        t0 = time.perf_counter()
        if start(name, "-alone").wait() != 0:
            raise RuntimeError(f"{tag}: nvcc failed on {name}")
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    procs = [start(name, "-together") for name in sorted(build.SOURCES)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f"{tag}: nvcc failed")
    secs["together"] = time.perf_counter() - t0
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--build", action="store_true",
                    help="first time nvcc on each source, alone and all "
                         "together")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("update_probe: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.scaffold_update import ops
    from repro_torch.models import model as M

    print(f"{args.tag}: repro_torch from {Path(ops.__file__).resolve()}",
          flush=True)
    out = {"tag": args.tag, "floors": {}}
    if args.build:
        out["build_s"] = build_seconds(args.tag)
        print(f"{args.tag} nvcc wall seconds: {out['build_s']}", flush=True)
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")

    def card(fn):
        return [cs.card_ms(fn, 20, flush, 1_000_000) for _ in range(TURNS)]

    empty = floor_lib(build)
    stream = torch.cuda.current_stream().cuda_stream
    for nbytes, grid in FLOORS:
        def launch(nbytes=nbytes, grid=grid):
            build.check(empty(nbytes, grid, stream), "launch_empty")

        ms = card(launch)
        out["floors"][f"empty_{nbytes}B_{grid}_blocks_ms"] = (
            statistics.median(ms))
        print(f"{args.tag} empty kernel, {nbytes} B parameter, {grid} "
              f"blocks: card time {cs.spread(ms)}", flush=True)
    ms = card(lambda: None)
    out["floors"]["events_ms"] = statistics.median(ms)
    print(f"{args.tag} event pair, nothing between: {cs.spread(ms)}",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(9)
    gemma = M.init_params(get_config("gemma3-1b"), gen, device="cuda")
    trees = {
        "mlp": {f"l{i}": torch.randn(s, generator=gen, device="cuda")
                for i, s in enumerate(MLP)},
        "quad": {"w": torch.randn(QUAD[0], generator=gen, device="cuda")},
        "gemma3-1b": gemma,
    }
    for tname, y in trees.items():
        g, c = ({k: torch.randn(v.shape, generator=gen, device="cuda",
                                dtype=v.dtype) for k, v in y.items()}
                for _ in range(2))
        m = {k: torch.randn(v.shape, generator=gen, device="cuda")
             for k, v in y.items()}
        n = sum(v.numel() for v in y.values())
        calls = {
            "B1": lambda: ops.scaffold_update_packed(y, g, c, ETA, out=y),
            "B2": lambda: ops.scaffold_momentum_update_packed(
                y, g, c, m, ETA, BETA, out=y, m_out=m)}
        for kname, call in calls.items():
            before = dict(ops.LAUNCHES)
            call()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                        if v != before[k]}
            card_all = card(call)
            per_call = [cs.cuda_ms(call, 20, flush=flush)
                        for _ in range(TURNS)]
            host = []
            for _ in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            row = dict(card_ms=statistics.median(card_all),
                       card_turns=card_all,
                       per_call_ms=statistics.median(per_call),
                       host_us=1e6 * statistics.median(host),
                       host_us_quartiles=[1e6 * q for q in
                                          statistics.quantiles(host, n=4)],
                       launches_a_call=launched)
            print(f"{args.tag} {kname} {tname} ({n} elements, {len(y)} "
                  f"leaves): card time {cs.spread(card_all)}; per call "
                  f"{cs.spread(per_call)}; wrapper host time "
                  f"{row['host_us']:.2f} us a call; launches a call "
                  f"{launched}", flush=True)
            out[f"{kname}_{tname}"] = row
        if tname == "mlp" and hasattr(ops, "_groups"):
            out["B1_mlp"]["host_split_us"] = host_split(ops, y, g, c)
            print(f"{args.tag} B1 mlp wrapper host time by part, us a call: "
                  f"{out['B1_mlp']['host_split_us']}", flush=True)
        if tname == "mlp":
            ys, gs = list(y.values()), list(g.values())
            ms = card(lambda: torch._foreach_add_(ys, gs, alpha=-ETA))
            out["foreach_add_mlp_ms"] = statistics.median(ms)
            print(f"{args.tag} torch._foreach_add_(ys, gs) at the MLP tree: "
                  f"card time {cs.spread(ms)}", flush=True)
        del y, g, c, m, calls
    del trees, gemma
    out["device"] = cs.nvidia_smi()
    print(out["device"], flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
