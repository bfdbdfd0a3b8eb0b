#!/usr/bin/env python3
"""Times the stacked layers' backward two ways on one CUDA card, in one
trainer, round by round: the model splitting each stacked leaf into its
layers once a forward (``torch.unbind``, what ``models/transformer.py::
apply_stack`` does) and indexing it ``v[i]`` once a layer (what it did
before; here ``torch.unbind`` is swapped for that indexing while a round
runs). The two give the same gradients bit for bit
(``tests/test_torch_hymba.py``); indexing's backward fills and adds a
zero tensor of the whole stacked leaf for every layer.

    python3 tools/stack_backward_probe.py

Two trainers, SCAFFOLD, N 4, S 2, K 2, batch 1, eta_l 0.01, seeded
weights: mamba2-2.7b at its published widths and 64 layers, seq 512 (a
3.47 GB stacked ``w_in``; ``chip_smoke.py`` phase 34's trainer), and
LoRA r 8 on llama3.2-3b at its 28 layers, seq 256 (phase 18's spec).
Each trainer runs a warm-up round, then rounds in the order unbind,
index, index, unbind, unbind, index; each round is timed by the host clock between card
synchronisations, beside its peak device memory
(``torch.cuda.max_memory_allocated``). It prints one line a trainer,
the card's name and power limit, and last one JSON object of the
numbers.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("unbind", "index", "index", "unbind", "unbind", "index")


def _indexed(v):
    return [v[i] for i in range(v.shape[0])]


def probe(tag: str, make) -> dict:
    """Rounds of the trainer ``make()`` in ``ORDER``; seconds and peak
    device bytes by way of splitting."""
    import torch

    tr = make()
    tr.run_round()
    torch.cuda.synchronize()
    unbind = torch.unbind
    out = {"unbind": [], "index": []}
    for way in ORDER:
        torch.unbind = unbind if way == "unbind" else _indexed
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr.run_round()
            torch.cuda.synchronize()
            out[way].append(dict(seconds=time.perf_counter() - t0,
                                 peak_bytes=torch.cuda.max_memory_allocated()))
        finally:
            torch.unbind = unbind
    tr.close()
    del tr
    torch.cuda.empty_cache()
    line = "; ".join(
        f"{way}: s/round " + ", ".join(f"{r['seconds']:.3f}" for r in rows)
        + f" (median {statistics.median(r['seconds'] for r in rows):.3f}), "
        f"peak {max(r['peak_bytes'] for r in rows) / 1e9:.2f} GB"
        for way, rows in out.items())
    print(f"{tag}: {line}", flush=True)
    return out


def main() -> int:
    """Probe both trainers; 0 when both ran."""
    import torch

    if not torch.cuda.is_available():
        print("stack_backward_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedRoundSpec

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    spec = C._lm_spec()
    mamba = dataclasses.replace(get_config("mamba2-2.7b"),
                                loss_chunk_vocab=C.SSM_CHUNK)
    # phase 18's spec, as the entry point builds it
    lora = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01,
                        update_space="lora", lora_rank=C.LORA_RANK)
    llama = dataclasses.replace(get_config("llama3.2-3b"),
                                loss_chunk_vocab=16032)
    result = {
        "mamba2-2.7b seq 512": probe(
            "mamba2-2.7b, 64 layers, seq 512",
            lambda: C._lm_trainer(mamba, spec, 512)),
        "lora llama3.2-3b seq 256": probe(
            "LoRA r 8 llama3.2-3b, 28 layers, seq 256",
            lambda: C._lm_trainer(llama, lora, 256)),
    }
    smi = C.nvidia_smi()
    print(smi)
    print(json.dumps({"card": smi, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
