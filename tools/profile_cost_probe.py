#!/usr/bin/env python3
"""What ``torch.profiler`` costs ``chip_smoke.py`` after a profiled
round, with the CPU activity recorded and without, on one CUDA card:

    python3 tools/profile_cost_probe.py [--archs gemma3-1b,hymba-1.5b]

For each architecture it builds the trainer of ``chip_smoke.py``'s
phase (gemma3-1b: phase 10, 26 layers at seq 2048; hymba-1.5b: phase
33, 32 layers at seq 2048; SCAFFOLD, N 4, S 2, K 2, batch 1, bf16), runs
one round unprofiled, then profiles four more rounds through
``chip_smoke._profile_round`` in turns: CPU and CUDA activity, CUDA
alone, CUDA alone, CPU and CUDA. Each line gives the profiler's own
seconds after the round (its trace collected, aggregated and tabled),
the events it kept and the round's device busy share (device time over
wall), so the two settings compare within one process on one card. It
prints the card's name and power limit, and last one JSON object of
the numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default="gemma3-1b,hymba-1.5b")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    import torch

    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        print("profile_cost_probe: needs a CUDA card", file=sys.stderr)
        return 2
    C.phase_build()
    chunks = {"gemma3-1b": get_config("gemma3-1b").vocab_size // 16,
              "hymba-1.5b": C.SSM_CHUNK}
    out = {}
    for arch in args.archs.split(","):
        spec = C._lm_spec()
        cfg, _, _ = C._lm_fit(spec, 2048, arch=arch, chunk=chunks[arch])
        tr = C._lm_trainer(cfg, spec, 2048)
        tr.run_round()
        rows = []
        for cpu in (True, False, False, True):
            tag = f"{arch} {'cpu+cuda' if cpu else 'cuda'}"
            busy = C._profile_round(tr, tag.replace(" ", "_"), cpu=cpu)
            rows.append(dict(cpu=cpu, busy=busy,
                             seconds=C.PROFILER_SECONDS[tag.replace(" ",
                                                                    "_")]))
            C.log(f"{tag}: the profiler's own {rows[-1]['seconds']:.1f} s, "
                  f"busy share {busy}")
        out[arch] = rows
        tr.close()
        del tr
        torch.cuda.empty_cache()
    print(C.nvidia_smi())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
