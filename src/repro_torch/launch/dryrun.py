"""Dry run: the cost of one step of an (arch x input shape) at published
widths, counted by ``launch.census`` without allocating device memory
(the JAX package's ``launch/dryrun.py``, which lowers and compiles the
step for a TPU mesh instead).

    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k \\
        --device cpu --mesh 16x16

The step is the reference's: ``federated_round`` over
``default_round_spec`` for ``train`` (the fused local step; x and c on
the device, the S sampled c_i rows on the host, as the trainer keeps
them), ``prefill`` for ``prefill``, and ``decode_step`` against the
shape's cache for ``decode``. MoE layers take ``gshard`` unless
``--moe-impl`` says otherwise, as in the reference. ``--device cuda``
(the default) counts the card path, hand-written kernels included, on
fake CUDA tensors, which need no card; ``--device cpu`` counts the CPU
path (the kernels' plain versions). The JSON
(``<out-dir>/<arch>__<shape>__<mesh>[__<tag>].json``) has the
reference's top-level keys:

  memory       the census's ``peak_bytes`` and the argument and output
               bytes on the counted device; at ``--mesh 16x16`` or
               ``2x16x16`` also ``per_device``: the bytes of x, c, c_i
               and the batch (train) or of the params and the batch
               (serve) on one device under ``dist``'s partition rules;
  cost_struct  flops, bytes and bytes_by_kind of the whole program on
               one device, and its hand-written kernel launches;
  roofline     the terms at this card's rates (below), the model's
               6ND (2ND serving) flops and their share of the census's.
  collectives  {} on one device (no collective runs); null at a larger
               mesh with ``why``: the port has no SPMD partitioner, so a
               partitioned program's per-device flops and collectives
               are not counted (also ``cost_xla`` and ``compile_s``
               are null: there is no compiler pass to report).

``--no-remat`` sets ``cfg.remat`` as the reference does; the port keeps
every layer's activations either way (``models.transformer``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from functools import partial

import torch

from repro_torch.configs import (
    SHAPES,
    default_round_spec,
    get_config,
    get_reduced,
    supports_shape,
)
from repro_torch.core import federated_round, make_grad_fn
from repro_torch.dist import (
    partition_client_states,
    partition_params,
    partition_serve_batch,
    partition_train_batch,
)
from repro_torch.launch import census as C
from repro_torch.models import model as M

# NVIDIA H100 SXM5 80 GB HBM3 at 700 W (NVIDIA's data sheet): dense bf16
# 989 TFLOP/s, HBM 3.35 TB/s, NVLink 450 GB/s a direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
CARD_BYTES = 80e9

MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

NO_PARTITIONER = ("the port has no SPMD partitioner and the card is one "
                  "GPU: a partitioned program's per-device flops and "
                  "collectives are not counted")


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis sizes alone (no devices): what the partition rules
    read."""

    shape: dict

    @property
    def axis_names(self):
        return tuple(self.shape)


def make_config(arch: str, *, preset: str = "full", moe_impl=None,
                remat=None, loss_chunk: int = 0, moe_group: int = 0,
                moe_cap: float = 0.0):
    """The arch's config with the dry run's overrides (the reference's
    ``run_combo``): MoE takes ``gshard`` unless ``moe_impl`` says."""
    cfg = get_config(arch) if preset == "full" else get_reduced(arch)
    over = {}
    if moe_impl:
        over["moe_impl"] = moe_impl
    elif cfg.moe is not None:
        over["moe_impl"] = "gshard"
    if remat is not None:
        over["remat"] = remat
    if loss_chunk:
        over["loss_chunk_vocab"] = loss_chunk
    if (moe_group or moe_cap) and cfg.moe is not None:
        moe_over = {}
        if moe_group:
            moe_over["gshard_group_size"] = moe_group
        if moe_cap:
            moe_over["capacity_factor"] = moe_cap
        over["moe"] = dataclasses.replace(cfg.moe, **moe_over)
    return dataclasses.replace(cfg, **over) if over else cfg


def make_round_spec(arch: str, shape, *, mesh: str = "1x1", strategy=None,
                    num_sampled: int = 0, local_steps: int = 0):
    """``default_round_spec`` with the reference's changes: 32 clients of
    local batch 2 on the multi-pod mesh (client_parallel), the strategy,
    and S or K with the global batch kept."""
    spec = default_round_spec(arch)
    if mesh == "2x16x16" and spec.strategy == "client_parallel":
        spec = dataclasses.replace(spec, num_sampled=32, local_batch=2)
    if strategy:
        spec = dataclasses.replace(spec, strategy=strategy)
    if num_sampled or local_steps:
        s = num_sampled or spec.num_sampled
        k = local_steps or spec.local_steps
        spec = dataclasses.replace(spec, num_sampled=s, local_steps=k,
                                   local_batch=shape.global_batch // (s * k))
    return spec


def _meta_params(cfg):
    return M.param_tree(cfg, None, torch.device("meta"))


def train_inputs(cfg, spec, shape):
    """Meta stand-ins of one round's ``(x, c, c_i, batches)``: c_i's (S,
    ...) rows on the host (``census.OnHost``), as the trainer keeps
    them."""
    x = _meta_params(cfg)
    c_i = {k: torch.empty((spec.num_sampled,) + tuple(v.shape),
                          dtype=v.dtype, device="meta") for k, v in x.items()}
    return x, _meta_params(cfg), c_i, M.input_specs(cfg, shape, spec)


def train_step(cfg, spec, use_fused_update: bool = True):
    """One round of the reference's dry run: ``federated_round`` over the
    model's loss, the fused local step by default (B1 on the card)."""
    grad_fn = make_grad_fn(partial(M.loss_fn, cfg))
    return partial(federated_round, grad_fn, spec,
                   use_fused_update=use_fused_update)


def _round_census(cfg, spec, shape, device, use_fused_update):
    x, c, c_i, batch = train_inputs(cfg, spec, shape)
    return C.census(train_step(cfg, spec, use_fused_update), x, c,
                    C.OnHost(c_i), batch, device=device)


def _combine(parts):
    """``sum(w * census)`` over ``(w, census)`` of the linear counts."""
    out = C.Census(device=parts[0][1].device, stand=parts[0][1].stand)
    for w, c in parts:
        out.flops += w * c.flops
        out.bytes += w * c.bytes
        out.ops += w * c.ops
        for k, v in c.bytes_by_kind.items():
            out.bytes_by_kind[k] = out.bytes_by_kind.get(k, 0) + w * v
        for k, v in c.kernel_launches.items():
            out.kernel_launches[k] = out.kernel_launches.get(k, 0) + w * v
    out.bytes_by_kind = {k: v for k, v in out.bytes_by_kind.items() if v}
    out.kernel_launches = {k: v for k, v in out.kernel_launches.items()
                           if v}
    return out


def round_census(cfg, spec, shape, device="cuda",
                 use_fused_update: bool = True) -> C.Census:
    """The census of one round, its clients and local steps counted by
    trip count (the reference walker's idea): every client runs the same
    ops, and every local step of a client too, so a count is ``a + S (b
    + K c)``; three small rounds, (S, K) = (1, 1), (1, 2) and (2, 1),
    give a, b and c, and the round's count follows for any S and K
    (exactly: the counts are sums of the same ops). The peak is the
    largest of the three's peaks above their arguments, plus the round's
    own argument bytes (its (S, K, b, ...) batch, and on the CPU its c_i
    rows); the output bytes are the round's. A round of at most 2 clients and 2
    steps is counted directly."""
    s, k = spec.num_sampled, spec.local_steps
    if s <= 2 and k <= 2:
        return _round_census(cfg, spec, shape, device, use_fused_update)

    def small(s_, k_):
        sp = dataclasses.replace(spec, num_sampled=s_, local_steps=k_,
                                 local_batch=spec.local_batch,
                                 num_clients=max(s_, 2))
        sh = dataclasses.replace(shape, global_batch=s_ * k_
                                 * spec.local_batch)
        return _round_census(cfg, sp, sh, device, use_fused_update)

    c11, c12, c21 = small(1, 1), small(1, 2), small(2, 1)
    # c = c12 - c11, b = c21 - c12, a = 2 c11 - c21
    out = _combine([(2 - s * k, c11), (s * k - s, c12), (s - 1, c21)])
    # the round's own argument bytes on the counted device (the c_i rows
    # lie on the host, which a census on the CPU counts as its device)
    x, c, c_i, batch = train_inputs(cfg, spec, shape)
    counted = [x, c, batch] + ([c_i] if out.stand == "cpu" else [])
    out.argument_bytes = sum(v.numel() * v.element_size()
                             for tree in counted for v in tree.values())
    out.output_bytes = c11.output_bytes
    out.peak_bytes = max(c.peak_bytes - c.argument_bytes
                         for c in (c11, c12, c21)) + out.argument_bytes
    return out


def step_census(cfg, shape, spec=None, device="cuda",
                use_fused_update: bool = True) -> C.Census:
    """The census of the shape's step (train: ``round_census``, prefill
    or decode)."""
    if shape.kind == "train":
        return round_census(cfg, spec, shape, device, use_fused_update)
    params = _meta_params(cfg)
    specs = M.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return C.census(partial(M.prefill, cfg), params, specs,
                        device=device)
    return C.census(partial(M.decode_step, cfg), params, specs["cache"],
                    specs["tokens"], specs["pos"], device=device)


def _tree_bytes(shardings, tree) -> int:
    """One device's bytes of ``tree`` under ``shardings`` (like trees)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(shardings[k], v) for k, v in tree.items())
    return shardings.shard_bytes(tuple(tree.shape), tree.element_size())


def per_device_bytes(cfg, shape, spec, mesh_name: str, strategy: str):
    """One device's bytes of the step's state under the ported partition
    rules on the shape-only ``mesh_name``."""
    mesh = ShapeMesh(MESHES[mesh_name])
    params = _meta_params(cfg)
    if shape.kind == "train":
        x, _, c_i, batch = train_inputs(cfg, spec, shape)
        x_sh = partition_params(x, mesh, strategy)
        out = {"x": _tree_bytes(x_sh, x), "c": _tree_bytes(x_sh, x),
               "c_i": _tree_bytes(
                   partition_client_states(c_i, mesh, strategy), c_i),
               "batch": _tree_bytes(
                   partition_train_batch(batch, mesh, strategy), batch)}
    else:
        specs = M.input_specs(cfg, shape)
        out = {"params": _tree_bytes(partition_params(params, mesh, strategy),
                                     params),
               "batch": _tree_bytes(partition_serve_batch(specs, mesh), specs)}
    out["total"] = sum(out.values())
    out.update(flops=None, collectives=None, why=NO_PARTITIONER)
    return out


def run_combo(arch: str, shape_name: str, *, mesh: str = "1x1",
              device: str = "cuda", preset: str = "full", moe_impl=None,
              strategy=None, remat=None, loss_chunk: int = 0,
              moe_group: int = 0, moe_cap: float = 0.0,
              num_sampled: int = 0, local_steps: int = 0,
              out_dir: str = "experiments/dryrun_torch", tag: str = "",
              shape=None):
    """Count one combo and write its JSON; returns the result. ``shape``
    overrides ``SHAPES[shape_name]`` (a smaller InputShape for tests)."""
    shape = shape or SHAPES[shape_name]
    cfg = make_config(arch, preset=preset, moe_impl=moe_impl, remat=remat,
                      loss_chunk=loss_chunk, moe_group=moe_group,
                      moe_cap=moe_cap)
    spec = None
    if shape.kind == "train":
        spec = make_round_spec(arch, shape, mesh=mesh, strategy=strategy,
                               num_sampled=num_sampled,
                               local_steps=local_steps)
        pstrat = spec.strategy
    else:
        pstrat = ("client_sequential" if arch == "deepseek-v3-671b"
                  else "client_parallel")
    t0 = time.time()
    cen = step_census(cfg, shape, spec, device=device)
    secs = time.time() - t0
    chips = 1
    for n in MESHES[mesh].values():
        chips *= n
    n_params = M.count_params_analytic(cfg)
    n_active = M.count_active_params(cfg)
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    compute = cen.flops / PEAK_FLOPS
    memory = cen.bytes / HBM_BW
    mem = {"peak_bytes": cen.peak_bytes,
           "argument_size_in_bytes": cen.argument_bytes,
           "output_size_in_bytes": cen.output_bytes,
           "temp_size_in_bytes": cen.peak_bytes - cen.argument_bytes,
           "fits_80gb": cen.peak_bytes <= CARD_BYTES}
    if mesh != "1x1":
        mem["per_device"] = per_device_bytes(cfg, shape, spec, mesh, pstrat)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh,
        "chips": chips,
        "strategy": spec.strategy if shape.kind == "train" else "serve",
        "tag": tag,
        "device": cen.device,
        "round_spec": (None if spec is None else
                       {"num_sampled": spec.num_sampled,
                        "local_steps": spec.local_steps,
                        "local_batch": spec.local_batch}),
        "params": n_params,
        "active_params": n_active,
        "lower_s": secs,  # the census's wall time (no lowering here)
        "compile_s": None,
        "memory": mem,
        "cost_xla": None,
        "cost_struct": {"flops": cen.flops, "bytes": cen.bytes,
                        "bytes_by_kind": cen.top_kinds(),
                        "kernel_launches": cen.kernel_launches,
                        "ops": cen.ops},
        "collectives": {} if mesh == "1x1" else None,
        "collective_bytes": 0 if mesh == "1x1" else None,
        "roofline": {
            "compute_term_s": compute,
            "memory_term_s": memory,
            "collective_term_s": 0.0 if mesh == "1x1" else None,
            "dominant": "compute" if compute >= memory else "memory",
            "model_flops_global": model_flops,
            "census_flops": cen.flops,
            "useful_flops_frac": (model_flops / cen.flops
                                  if cen.flops else None),
        },
    }
    if mesh != "1x1":
        result["why"] = NO_PARTITIONER
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{out_dir}/{arch}__{shape_name}__{mesh}{suffix}.json"
    with open(fname, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: result[k] for k in
                      ("arch", "shape", "mesh", "device", "strategy",
                       "lower_s", "memory", "roofline")}, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="1x1", choices=list(MESHES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--preset", default="full", choices=["full", "reduced"])
    ap.add_argument("--moe-impl", default=None, choices=["ragged", "gshard"])
    ap.add_argument("--strategy", default=None,
                    choices=["client_parallel", "client_sequential"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--moe-cap", type=float, default=0.0)
    ap.add_argument("--num-sampled", type=int, default=0)
    ap.add_argument("--local-steps", type=int, default=0)
    ap.add_argument("--loss-chunk", type=int, default=0)
    args = ap.parse_args(argv)
    if not supports_shape(args.arch, args.shape):
        print(f"SKIP {args.arch} x {args.shape} (long_500k runs only on "
              f"the windowed and state-space archs)")
        return None
    return run_combo(args.arch, args.shape, mesh=args.mesh,
                     device=args.device, preset=args.preset,
                     moe_impl=args.moe_impl, strategy=args.strategy,
                     remat=(False if args.no_remat else None),
                     loss_chunk=args.loss_chunk, moe_group=args.moe_group,
                     moe_cap=args.moe_cap, num_sampled=args.num_sampled,
                     local_steps=args.local_steps, out_dir=args.out_dir,
                     tag=args.tag)


if __name__ == "__main__":
    main()
