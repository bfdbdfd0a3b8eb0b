"""Transformer composition (the JAX package's ``models/transformer.py``):
layers grouped into runs of one signature, each run's parameters stacked
on a leading layer axis, exactly the reference's leaf layout
(``layers/<group>/attn/wq`` of shape ``(count, E, H*D)``), each leaf in
its own dtype (a bf16 model keeps the SSD's ``a_log``, ``dt_bias`` and
``d_skip`` in fp32, as the reference does).

The ``"F"`` (full causal or prefix-LM attention + dense MLP), ``"W"``
(sliding-window attention + dense MLP), ``"M"`` (Mamba2 SSD) and ``"Y"``
(attention and Mamba2 in parallel on one norm, + dense MLP) layers are
ported, with MLA in place of GQA attention where the config has one,
and so are the cross-attention of an encoder-decoder's decoder layers,
the encoder tower (whisper) and the routed mixture of experts in place
of the MLP of an MoE layer (``moe/...``; the dense layers before
``first_dense_layers`` take an MLP of width ``dense_d_ff``).

Decode caches are flat dicts in the same layout: each layer's cache
stacked on the group's layer axis and keyed by the reference cache's
path, ``layers/<g>/attn/k`` (count, B, C, Hkv, D), ``attn/v``,
``attn/ckv`` and ``attn/k_rope`` (MLA), ``mamba/conv`` and
``mamba/state``, ``cross_kv/0`` and ``cross_kv/1`` (an encoder-decoder's
cross-attention keys and values). A decode step writes each layer's new
entries through its view of the stacked buffers.
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
    has_cross: bool = False  # whisper's decoder layers


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
        if g.kind not in ("F", "W", "M", "Y"):
            raise NotImplementedError(f"layer group {g}: unknown kind")
    return groups


def sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of flat dict ``p`` under ``prefix + "/"``, prefix cut."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _init_layer(cfg, gen, kind: str, dtype, device, has_cross: bool = False,
                uses_moe: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's leaves, the reference's per kind: ``"F"``/``"W"``
    ln_attn, attn, ln_mlp, mlp (moe in an MoE layer; a dense layer of a
    model with ``first_dense_layers`` has an MLP of width
    ``dense_d_ff``); ``"Y"`` those and ln_mamba, mamba (the forward reads
    ln_attn for both branches: ln_mamba stays unread, as in the
    reference); ``"M"`` ln_attn, mamba; a decoder layer of an
    encoder-decoder also ln_cross, cross."""
    p: Dict[str, torch.Tensor] = {}

    def norm(name):
        for k, v in L.init_norm(cfg, cfg.d_model, dtype, device).items():
            p[f"{name}/{k}"] = v

    if kind in ("F", "W", "Y"):
        norm("ln_attn")
        init_attn = L.init_mla if cfg.mla is not None else L.init_attention
        for k, v in init_attn(cfg, gen, dtype, device).items():
            p[f"attn/{k}"] = v
        norm("ln_mlp")
        if uses_moe:
            for k, v in L.init_moe(cfg, gen, dtype, device).items():
                p[f"moe/{k}"] = v
        else:
            d_ff = None
            if cfg.moe is not None and cfg.moe.first_dense_layers:
                d_ff = cfg.moe.dense_d_ff
            for k, v in L.init_mlp(cfg, gen, dtype, device, d_ff).items():
                p[f"mlp/{k}"] = v
    if kind in ("M", "Y"):
        norm("ln_mamba" if kind == "Y" else "ln_attn")
        for k, v in L.init_mamba(cfg, gen, dtype, device).items():
            p[f"mamba/{k}"] = v
    if has_cross:
        norm("ln_cross")
        for k, v in L.init_attention(cfg, gen, dtype, device).items():
            p[f"cross/{k}"] = v
    return p


def _init_stacked(cfg, gen, kind: str, count: int, prefix: str, dtype,
                  device, has_cross: bool = False,
                  uses_moe: bool = False) -> Dict[str, torch.Tensor]:
    """``count`` layers of ``kind`` stacked, keyed ``<prefix><leaf path>``;
    drawn one layer at a time into the stacked tensors, each in its
    leaf's own dtype."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(count):
        for k, v in _init_layer(cfg, gen, kind, dtype, device,
                                has_cross, uses_moe).items():
            key = prefix + k
            if i == 0:
                out[key] = torch.empty((count,) + tuple(v.shape),
                                       dtype=v.dtype, device=device)
            out[key][i].copy_(v)
    return out


def init_stack(cfg, gen, dtype, device) -> Dict[str, torch.Tensor]:
    """Per-group stacked layer params, keyed ``layers/<g>/<leaf path>``."""
    out: Dict[str, torch.Tensor] = {}
    for gi, g in enumerate(layer_groups(cfg)):
        out.update(_init_stacked(cfg, gen, g.kind, g.count, f"layers/{gi}/",
                                 dtype, device, g.has_cross, g.uses_moe))
    return out


def _cross_attention(cfg, p, x, enc_out):
    """Cross-attention: queries from the decoder's x, keys and values from
    the encoder's output, no RoPE, the "full" mask."""
    b, s, e = x.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    se = enc_out.shape[1]
    q = (x @ p["wq"]).reshape(b, s, h, d)
    k = (enc_out @ p["wk"]).reshape(b, se, hkv, d)
    v = (enc_out @ p["wv"]).reshape(b, se, hkv, d)
    out = L.dense_attention(q, k, v, mask_kind="full")
    return out.reshape(b, s, h * d) @ p["wo"]


def _ffn(cfg, p, h, uses_moe: bool):
    """The layer's feed-forward part of the normed h: (out, aux), the
    MoE block by ``cfg.moe_impl`` in an MoE layer, else the MLP (aux
    None)."""
    if uses_moe:
        return L.moe_block(cfg, sub(p, "moe"), h, impl=cfg.moe_impl)
    return L.mlp_block(cfg, sub(p, "mlp"), h), None


def _apply_layer(cfg, p, x, positions, kind: str, *, prefix_len: int = 0,
                 enc_out=None, uses_moe: bool = False):
    """Full-sequence forward of one layer of ``kind`` -> (x, aux), aux
    the MoE block's load-balance loss (None in a dense layer); a decoder
    layer attends to ``enc_out`` after its self-attention."""
    h_in = L.apply_norm(cfg, x, sub(p, "ln_attn"))
    if kind == "M":
        return x + L.mamba_block(cfg, sub(p, "mamba"), h_in), None
    attn_kind = kind
    if kind == "Y":
        attn_kind = "W" if cfg.sliding_window else "F"
    if cfg.mla is not None:
        attn_out = L.mla_block(cfg, sub(p, "attn"), h_in, positions,
                               prefix_len=prefix_len)
    else:
        attn_out = L.attention_block(cfg, sub(p, "attn"), h_in, positions,
                                     kind=attn_kind, prefix_len=prefix_len)
    if kind == "Y":
        # Hymba: attention and mamba heads in parallel on the same input
        mamba_out = L.mamba_block(cfg, sub(p, "mamba"), h_in)
        x = x + 0.5 * (attn_out + mamba_out)
    else:
        x = x + attn_out
        if enc_out is not None:
            hc = L.apply_norm(cfg, x, sub(p, "ln_cross"))
            x = x + _cross_attention(cfg, sub(p, "cross"), hc, enc_out)
    h2 = L.apply_norm(cfg, x, sub(p, "ln_mlp"))
    out, aux = _ffn(cfg, p, h2, uses_moe)
    return x + out, aux


def _layers(p, prefix: str):
    """The stacked leaves under ``prefix``, each split into its layers
    (``torch.unbind``), as one dict a layer."""
    stack = {k: torch.unbind(v) for k, v in sub(p, prefix).items()}
    count = len(next(iter(stack.values())))
    return [{k: v[i] for k, v in stack.items()} for i in range(count)]


def apply_stack(cfg, params, x, positions, *, prefix_len: int = 0,
                enc_out=None):
    """Forward through all layer groups; returns (x, moe_aux), the MoE
    layers' load-balance losses summed in layer order (fp32 0 without
    one).
    ``prefix_len`` > 0 gives the ``"F"`` layers a prefix LM's mask;
    ``enc_out`` is the encoder's output that decoder layers attend to.

    Each stacked leaf is split into its layers once a forward
    (``torch.unbind``), whose backward stacks the layers' gradients once.
    Indexing ``v[i]`` a layer would fill and add a zero tensor of the
    whole stacked leaf per layer in the backward: O(L^2) bytes."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, g in enumerate(layer_groups(cfg)):
        for p in _layers(params, f"layers/{gi}"):
            x, aux = _apply_layer(cfg, p, x, positions, g.kind,
                                  prefix_len=prefix_len, enc_out=enc_out,
                                  uses_moe=g.uses_moe)
            if aux is not None:
                total = total + aux
    return x, total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_layer(cfg, p, x, cache, pos, kind: str, rope,
                  uses_moe: bool = False):
    """One-token decode of one layer, x (B, 1, E) at ``pos`` (B,); writes
    the layer's ``cache`` (its flat dict of views) in place. ``rope`` is
    the step's RoPE table, shared by the layers. A ``"Y"`` layer's
    attention cache is a ``"W"`` ring buffer when the config has a
    window; a decoder layer attends to its cached ``cross_kv`` (no RoPE,
    the "full" mask) after its self-attention."""
    h_in = L.apply_norm(cfg, x, sub(p, "ln_attn"))
    if kind == "M":
        return x + L.mamba_decode(cfg, sub(p, "mamba"), h_in,
                                  sub(cache, "mamba"), pos)
    if kind == "Y":
        attn_out = L.attention_decode(
            cfg, sub(p, "attn"), h_in, sub(cache, "attn"), pos,
            kind="W" if cfg.sliding_window else "F", rope=rope)
        mamba_out = L.mamba_decode(cfg, sub(p, "mamba"), h_in,
                                   sub(cache, "mamba"), pos)
        x = x + 0.5 * (attn_out + mamba_out)
    else:
        if cfg.mla is not None:
            x = x + L.mla_decode(cfg, sub(p, "attn"), h_in,
                                 sub(cache, "attn"), pos, rope=rope)
        else:
            x = x + L.attention_decode(cfg, sub(p, "attn"), h_in,
                                       sub(cache, "attn"), pos, kind=kind,
                                       rope=rope)
        if "cross_kv/0" in cache:
            hc = L.apply_norm(cfg, x, sub(p, "ln_cross"))
            b, h, d = x.shape[0], cfg.num_heads, cfg.head_dim
            q = (hc @ p["cross/wq"]).reshape(b, 1, h, d)
            out = L.dense_attention(q, cache["cross_kv/0"],
                                    cache["cross_kv/1"], mask_kind="full")
            x = x + out.reshape(b, 1, h * d) @ p["cross/wo"]
    h2 = L.apply_norm(cfg, x, sub(p, "ln_mlp"))
    return x + _ffn(cfg, p, h2, uses_moe)[0]


def _init_layer_cache(cfg, g: LayerGroup, batch: int, seq_len: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    """One layer's zero cache, keyed by the reference's paths."""
    cache: Dict[str, torch.Tensor] = {}

    def put(name, leaves):
        cache.update({f"{name}/{k}": v for k, v in leaves.items()})

    if g.kind in ("F", "W"):
        if cfg.mla is not None:
            put("attn", L.init_mla_cache(cfg, batch, seq_len, dtype, device))
        else:
            put("attn", L.init_attention_cache(cfg, batch, seq_len, dtype,
                                               g.kind, device))
    if g.kind == "Y":
        put("attn", L.init_attention_cache(
            cfg, batch, seq_len, dtype, "W" if cfg.sliding_window else "F",
            device))
    if g.kind in ("M", "Y"):
        put("mamba", L.init_mamba_cache(cfg, batch, dtype, device))
    if g.has_cross:
        shape = (batch, cfg.encoder.num_frames, cfg.num_kv_heads,
                 cfg.head_dim)
        put("cross_kv", {i: torch.zeros(shape, dtype=dtype, device=device)
                         for i in ("0", "1")})
    return cache


def init_cache(cfg, batch: int, seq_len: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Zero decode caches of every group, each layer's stacked on the
    group's layer axis: ``layers/<g>/<cache path>`` (count, ...)."""
    out: Dict[str, torch.Tensor] = {}
    for gi, g in enumerate(layer_groups(cfg)):
        for k, v in _init_layer_cache(cfg, g, batch, seq_len, dtype,
                                      device).items():
            out[f"layers/{gi}/{k}"] = torch.zeros(
                (g.count,) + tuple(v.shape), dtype=v.dtype, device=device)
    return out


def decode_stack(cfg, params, x, cache, pos):
    """One-token decode through all groups; returns x and writes each
    layer's entries of ``cache`` in place (through ``torch.unbind``'s
    views of the stacked buffers). The RoPE table at ``pos`` is built
    once a step for every attention layer (at MLA's rope dim, or the
    head dim)."""
    dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim
    rope = L.rope_table(pos[:, None], dim, cfg.rope_theta)
    for gi, g in enumerate(layer_groups(cfg)):
        prefix = f"layers/{gi}"
        for p, c in zip(_layers(params, prefix), _layers(cache, prefix)):
            x = _decode_layer(cfg, p, x, c, pos, g.kind, rope, g.uses_moe)
    return x


# ---------------------------------------------------------------------------
# encoder tower (whisper)
# ---------------------------------------------------------------------------


def init_encoder(cfg, gen, dtype, device) -> Dict[str, torch.Tensor]:
    """The encoder's leaves, keyed as the reference's pytree under
    ``encoder``: ``layers/<leaf path>`` stacked over its layers (ln_attn,
    attn, ln_mlp, mlp, as an ``"F"`` layer) and ``ln_post``."""
    out = _init_stacked(cfg, gen, "F", cfg.encoder.num_layers, "layers/",
                        dtype, device)
    for k, v in L.init_norm(cfg, cfg.d_model, dtype, device).items():
        out[f"ln_post/{k}"] = v
    return out


def apply_encoder(cfg, p, frames):
    """frames (B, T, E), the stub conv frontend's embeddings -> (B, T, E):
    RoPE over the frames, bidirectional ("full") self-attention and the
    MLP in each layer, then ``ln_post``."""
    b, t, e = frames.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.arange(t, device=frames.device)[None].expand(b, t)
    x = frames
    for pl in _layers(p, "layers"):
        h_in = L.apply_norm(cfg, x, sub(pl, "ln_attn"))
        q = (h_in @ pl["attn/wq"]).reshape(b, t, h, d)
        k = (h_in @ pl["attn/wk"]).reshape(b, t, hkv, d)
        v = (h_in @ pl["attn/wv"]).reshape(b, t, hkv, d)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out = L.dense_attention(q, k, v, mask_kind="full")
        x = x + out.reshape(b, t, h * d) @ pl["attn/wo"]
        h2 = L.apply_norm(cfg, x, sub(pl, "ln_mlp"))
        x = x + L.mlp_block(cfg, sub(pl, "mlp"), h2)
    return L.apply_norm(cfg, x, sub(p, "ln_post"))
