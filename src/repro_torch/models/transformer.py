"""Transformer composition (the JAX package's ``models/transformer.py``):
layers grouped into runs of one signature, each run's parameters stacked
on a leading layer axis, exactly the reference's leaf layout
(``layers/<group>/attn/wq`` of shape ``(count, E, H*D)``), each leaf in
its own dtype (a bf16 model keeps the SSD's ``a_log``, ``dt_bias`` and
``d_skip`` in fp32, as the reference does).

The ``"F"`` (full causal attention + dense MLP), ``"W"``
(sliding-window attention + dense MLP), ``"M"`` (Mamba2 SSD) and ``"Y"``
(attention and Mamba2 in parallel on one norm, + dense MLP) layers are
ported; MoE and cross-attention layers raise ``NotImplementedError``.
The reference rematerialises each layer in the backward pass
(``cfg.remat``); the port keeps the activations (a ``"W"`` layer's
attention keeps only its q, k and v and recomputes the rest in the
backward pass), which changes memory, not values.
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
        if g.kind not in ("F", "W", "M", "Y") or g.uses_moe or g.has_cross:
            raise NotImplementedError(
                f"layer group {g}: not ported yet (only dense 'F', 'W', "
                f"'M' and 'Y' layers are)")
    return groups


def sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of flat dict ``p`` under ``prefix + "/"``, prefix cut."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _init_layer(cfg, gen, kind: str, dtype, device) -> Dict[str, torch.Tensor]:
    """One layer's leaves, the reference's per kind: ``"F"``/``"W"``
    ln_attn, attn, ln_mlp, mlp; ``"Y"`` those and ln_mamba, mamba (the
    forward reads ln_attn for both branches: ln_mamba stays unread, as
    in the reference); ``"M"`` ln_attn, mamba."""
    p: Dict[str, torch.Tensor] = {}

    def norm(name):
        p[f"{name}/scale"] = L.init_norm(cfg, cfg.d_model, dtype,
                                         device)["scale"]

    if kind in ("F", "W", "Y"):
        norm("ln_attn")
        for k, v in L.init_attention(cfg, gen, dtype, device).items():
            p[f"attn/{k}"] = v
        norm("ln_mlp")
        for k, v in L.init_mlp(cfg, gen, dtype, device).items():
            p[f"mlp/{k}"] = v
    if kind in ("M", "Y"):
        norm("ln_mamba" if kind == "Y" else "ln_attn")
        for k, v in L.init_mamba(cfg, gen, dtype, device).items():
            p[f"mamba/{k}"] = v
    return p


def init_stack(cfg, gen, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-group stacked layer params, keyed ``layers/<g>/<leaf path>``;
    drawn one layer at a time into the stacked tensors, each in its
    leaf's own dtype."""
    out: Dict[str, torch.Tensor] = {}
    for gi, g in enumerate(layer_groups(cfg)):
        for i in range(g.count):
            for k, v in _init_layer(cfg, gen, g.kind, dtype, device).items():
                key = f"layers/{gi}/{k}"
                if i == 0:
                    out[key] = torch.empty((g.count,) + tuple(v.shape),
                                           dtype=v.dtype, device=device)
                out[key][i].copy_(v)
    return out


def _apply_layer(cfg, p, x, positions, kind: str):
    """Full-sequence forward of one dense layer of ``kind``."""
    h_in = L.apply_norm(cfg, x, sub(p, "ln_attn"))
    if kind == "M":
        return x + L.mamba_block(cfg, sub(p, "mamba"), h_in)
    attn_kind = kind
    if kind == "Y":
        attn_kind = "W" if cfg.sliding_window else "F"
    attn_out = L.attention_block(cfg, sub(p, "attn"), h_in, positions,
                                 kind=attn_kind)
    if kind == "Y":
        # Hymba: attention and mamba heads in parallel on the same input
        mamba_out = L.mamba_block(cfg, sub(p, "mamba"), h_in)
        x = x + 0.5 * (attn_out + mamba_out)
    else:
        x = x + attn_out
    h2 = L.apply_norm(cfg, x, sub(p, "ln_mlp"))
    return x + L.mlp_block(cfg, sub(p, "mlp"), h2)


def apply_stack(cfg, params, x, positions):
    """Forward through all layer groups; returns (x, moe_aux = 0).

    Each stacked leaf is split into its layers once a forward
    (``torch.unbind``), whose backward stacks the layers' gradients once.
    Indexing ``v[i]`` a layer would fill and add a zero tensor of the
    whole stacked leaf per layer in the backward: O(L^2) bytes."""
    for gi, g in enumerate(layer_groups(cfg)):
        stack = {k: torch.unbind(v) for k, v in
                 sub(params, f"layers/{gi}").items()}
        for i in range(g.count):
            x = _apply_layer(cfg, {k: v[i] for k, v in stack.items()}, x,
                             positions, g.kind)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
