"""Transformer composition (the JAX package's ``models/transformer.py``):
layers grouped into runs of one signature, each run's parameters stacked
on a leading layer axis, exactly the reference's leaf layout
(``layers/<group>/attn/wq`` of shape ``(count, E, H*D)``).

The ``"F"`` (full causal attention + dense MLP) and ``"W"``
(sliding-window attention + dense MLP) layers are ported; the others
raise ``NotImplementedError``. The reference rematerialises each layer
in the backward pass (``cfg.remat``); the port keeps the activations
(a ``"W"`` layer's attention keeps only its q, k and v and recomputes
the rest in the backward pass), which changes memory, not values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """A run of ``count`` consecutive layers of one signature."""

    kind: str  # F | W | M | Y
    uses_moe: bool
    count: int
    has_cross: bool = False


def layer_groups(cfg) -> List[LayerGroup]:
    """The config's layers as maximal runs of one signature."""
    pattern = cfg.pattern_for_layers()
    has_cross = cfg.encoder is not None
    sigs = [(pattern[i], cfg.layer_uses_moe(i), has_cross)
            for i in range(cfg.num_layers)]
    groups: List[LayerGroup] = []
    for sig in sigs:
        if groups and (groups[-1].kind, groups[-1].uses_moe,
                       groups[-1].has_cross) == sig:
            groups[-1] = dataclasses.replace(groups[-1],
                                             count=groups[-1].count + 1)
        else:
            groups.append(LayerGroup(sig[0], sig[1], 1, sig[2]))
    for g in groups:
        if g.kind not in ("F", "W") or g.uses_moe or g.has_cross:
            raise NotImplementedError(
                f"layer group {g}: not ported yet (only dense 'F' and 'W' "
                f"layers are)")
    return groups


def sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of flat dict ``p`` under ``prefix + "/"``, prefix cut."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _init_layer(cfg, gen, dtype, device) -> Dict[str, torch.Tensor]:
    p = {"ln_attn/scale": L.init_norm(cfg, cfg.d_model, dtype, device)["scale"]}
    for k, v in L.init_attention(cfg, gen, dtype, device).items():
        p[f"attn/{k}"] = v
    p["ln_mlp/scale"] = L.init_norm(cfg, cfg.d_model, dtype, device)["scale"]
    for k, v in L.init_mlp(cfg, gen, dtype, device).items():
        p[f"mlp/{k}"] = v
    return p


def init_stack(cfg, gen, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-group stacked layer params, keyed ``layers/<g>/<leaf path>``;
    drawn one layer at a time into the stacked tensors."""
    out: Dict[str, torch.Tensor] = {}
    for gi, g in enumerate(layer_groups(cfg)):
        for i in range(g.count):
            for k, v in _init_layer(cfg, gen, dtype, device).items():
                key = f"layers/{gi}/{k}"
                if i == 0:
                    out[key] = torch.empty((g.count,) + tuple(v.shape),
                                           dtype=dtype, device=device)
                out[key][i].copy_(v)
    return out


def _apply_layer(cfg, p, x, positions, kind: str):
    """Full-sequence forward of one dense "F" or "W" layer."""
    h_in = L.apply_norm(cfg, x, sub(p, "ln_attn"))
    x = x + L.attention_block(cfg, sub(p, "attn"), h_in, positions,
                              kind=kind)
    h2 = L.apply_norm(cfg, x, sub(p, "ln_mlp"))
    return x + L.mlp_block(cfg, sub(p, "mlp"), h2)


def apply_stack(cfg, params, x, positions):
    """Forward through all layer groups; returns (x, moe_aux = 0)."""
    for gi, g in enumerate(layer_groups(cfg)):
        stack = sub(params, f"layers/{gi}")
        for i in range(g.count):
            x = _apply_layer(cfg, {k: v[i] for k, v in stack.items()}, x,
                             positions, g.kind)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
