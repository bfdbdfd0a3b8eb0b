"""Public model API (the JAX package's ``models/model.py``): init,
forward and the next-token loss that the federated core consumes, and
the serving substrate: ``prefill``, ``init_cache``,
``populate_encoder_cache`` and ``decode_step``, and the dry run's
``input_specs``.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
pytree paths (``embed``, ``ln_final/scale``, ``layers/0/attn/wq``,
``unembed``, ``prefix_proj``, ``encoder/layers/attn/wq``, ...), so
``repro_torch.convert.params_from_jax`` carries the JAX package's
weights across leaf by leaf.

A batch is ``{"tokens", "labels"}`` of (B, S_text), plus the stub
frontends' embeddings (B, P, E) where the model has one: ``patches``
for a prefix LM (paligemma), ``frames`` for an encoder-decoder
(whisper).

A decode cache is a flat dict keyed by the reference cache's paths
(``layers/<g>/attn/k``, ..., ``enc_out``; ``models.transformer``), on
the parameters' device; ``decode_step`` writes it in place and reads
nothing back to the host, so rows may sit at different positions.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.activations import constrain_batch_dim, constrain_spec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg, gen=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Random initial parameters drawn from ``gen`` (a ``torch.Generator``
    on ``device``; a fresh one seeded with 0 when None). The draws differ
    from the reference's threefry keys; the shapes, dtypes and scales are
    the reference's."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    return param_tree(cfg, gen, dev)


def param_tree(cfg, gen, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The parameter tree of ``cfg`` on ``dev``, drawn from ``gen``. On
    the meta device (``gen`` None) it allocates nothing: the leaf paths,
    shapes and dtypes alone."""
    dtype = _dtype(cfg.param_dtype)
    e = cfg.d_model
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, e), dtype, dev)}
    for k, v in L.init_norm(cfg, e, dtype, dev).items():
        params[f"ln_final/{k}"] = v
    params.update(T.init_stack(cfg, gen, dtype, dev))
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (e, cfg.vocab_size), dtype, dev)
    if cfg.encoder is not None:
        for k, v in T.init_encoder(cfg, gen, dtype, dev).items():
            params[f"encoder/{k}"] = v
    if cfg.num_prefix_tokens:
        # the projector stub of the modality prefix
        params["prefix_proj"] = L.dense_init(gen, (e, e), dtype, dev)
    return params


def _mamba_params(cfg) -> int:
    """Parameters of one Mamba2 block (``layers.init_mamba``)."""
    sm = cfg.ssm
    e = cfg.d_model
    di, h, gn = sm.d_inner(e), sm.n_heads(e), sm.n_groups * sm.d_state
    conv_dim = di + 2 * gn
    return (e * (2 * di + 2 * gn + h) + (sm.conv_kernel + 1) * conv_dim
            + 3 * h + di + di * e)


def count_params_analytic(cfg) -> int:
    """Total parameter count from the shapes (no allocation)."""
    e, h, hkv, d, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    norm = 2 * e if cfg.norm_kind == "layernorm" else e  # + the bias
    attn = e * h * d + 2 * e * hkv * d + h * d * e
    if cfg.mla is not None:
        m = cfg.mla
        qr, kvr, dn, dr, dv = (m.q_lora_rank, m.kv_lora_rank,
                               m.qk_nope_head_dim, m.qk_rope_head_dim,
                               m.v_head_dim)
        attn = (e * qr + qr + qr * h * (dn + dr) + e * kvr + kvr + e * dr
                + kvr * h * (dn + dv) + h * dv * e)  # layers.init_mla
    n_mats = 2 if cfg.mlp_kind == "gelu" else 3
    mlp = n_mats * e * f
    dense = 2 * norm + attn + mlp
    cross = norm + attn if cfg.encoder is not None else 0
    per_kind = {"F": dense + cross, "W": dense + cross}
    if cfg.ssm is not None:
        per_kind["M"] = norm + _mamba_params(cfg) + cross  # ln_attn + mamba
        per_kind["Y"] = dense + norm + _mamba_params(cfg) + cross
    total = cfg.vocab_size * e + norm + sum(
        per_kind[k] for k in cfg.pattern_for_layers())
    if cfg.moe is not None:
        # an MoE layer's experts in place of its MLP (layers.init_moe); a
        # dense layer's MLP is dense_d_ff wide once first_dense_layers > 0
        mo = cfg.moe
        moe = e * mo.num_experts + 3 * mo.num_experts * e * mo.expert_d_ff
        if mo.num_shared_experts:
            moe += 3 * e * mo.shared_d_ff * mo.num_shared_experts
        dense_f = mo.dense_d_ff if mo.first_dense_layers else f
        for i in range(cfg.num_layers):
            total += (moe - mlp if cfg.layer_uses_moe(i)
                      else n_mats * e * dense_f - mlp)
    if not cfg.tie_embeddings:
        total += e * cfg.vocab_size  # unembed
    if cfg.encoder is not None:
        total += cfg.encoder.num_layers * dense + norm  # + ln_post
    if cfg.num_prefix_tokens:
        total += e * e  # prefix_proj
    return total


def count_active_params(cfg) -> int:
    """Parameters active a token: an MoE layer's routed experts count
    ``top_k`` of their ``num_experts`` (the reference's)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    mo = cfg.moe
    n_moe_layers = sum(cfg.layer_uses_moe(i) for i in range(cfg.num_layers))
    per_expert = 3 * cfg.d_model * mo.expert_d_ff
    routed = n_moe_layers * mo.num_experts * per_expert
    active_routed = n_moe_layers * mo.top_k * per_expert
    return total - routed + active_routed


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d_model) to the table's dtype first
        # (bf16: sqrt(1152) = 33.94 -> 34.0)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return constrain_batch_dim(x.to(_dtype(cfg.compute_dtype)))


def _unembed(cfg, params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ params["unembed"]
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward_hidden(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm -> (hidden (B,S,E), aux).
    An encoder-decoder runs ``frames`` through its encoder first; a
    prefix LM prepends ``patches @ prefix_proj`` to the text and drops
    the prefix's positions after the final norm, so the hidden states
    are the text's."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    enc_out = None
    prefix_len = 0
    if cfg.encoder is not None:
        enc_out = T.apply_encoder(cfg, T.sub(params, "encoder"),
                                  batch["frames"].to(x.dtype))
    if cfg.num_prefix_tokens:
        pre = batch["patches"].to(x.dtype) @ params["prefix_proj"]
        x = torch.cat([pre, x], dim=1)
        prefix_len = cfg.num_prefix_tokens
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = T.apply_stack(cfg, params, x, positions, prefix_len=prefix_len,
                           enc_out=enc_out)
    x = L.apply_norm(cfg, x, T.sub(params, "ln_final"))
    if cfg.num_prefix_tokens:
        x = x[:, cfg.num_prefix_tokens:]
    return x, aux


def forward(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), aux)."""
    x, aux = forward_hidden(cfg, params, batch)
    return _unembed(cfg, params, x), aux


def _ce_chunk(hidden, w_chunk, labels, m, acc, gold, lo: int,
              softcap: float):
    """One vocab chunk of the streaming cross-entropy: the online
    logsumexp carry ``(m, acc)`` and the gold logit of the labels this
    chunk owns."""
    logits = (hidden @ w_chunk.T).float()  # (B, S, C)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    c = w_chunk.shape[0]
    m_new = torch.maximum(m, logits.amax(-1))
    acc = acc * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(-1)
    rel = labels - lo
    in_chunk = (rel >= 0) & (rel < c)
    picked = torch.gather(logits, -1,
                          rel.clamp(0, c - 1)[..., None])[..., 0]
    gold = gold + torch.where(in_chunk, picked, torch.zeros_like(picked))
    return m_new, acc, gold


def _chunked_ce(cfg, params, hidden, labels, mask):
    """Streaming softmax cross-entropy over vocab chunks: never builds the
    (tokens, V) fp32 logits. Each chunk is recomputed in the backward pass
    (the reference's ``jax.checkpoint``). The last chunk is short where
    the reference pads the vocab with masked rows; the result is the
    same."""
    chunk = cfg.loss_chunk_vocab
    b, s, _ = hidden.shape
    m = torch.full((b, s), -1e30, dtype=torch.float32, device=hidden.device)
    acc = torch.zeros((b, s), dtype=torch.float32, device=hidden.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=hidden.device)
    if cfg.tie_embeddings:
        chunks = params["embed"].split(chunk, dim=0)
    else:
        # column blocks of unembed, each read as (C, E): its gradient is
        # their concatenation, contiguous as the fused steps need it
        chunks = [u.T for u in params["unembed"].split(chunk, dim=1)]
    for ci, w_chunk in enumerate(chunks):
        # each chunk stays split over "model" on its vocab rows (the
        # reference's constraint on its stacked chunks)
        w_chunk = constrain_spec(w_chunk, ("model", None))
        m, acc, gold = checkpoint(_ce_chunk, hidden, w_chunk, labels, m, acc,
                                  gold, ci * chunk, cfg.logit_softcap,
                                  use_reentrant=False)
    logz = m + torch.log(torch.clamp(acc, min=1e-30))
    return (logz - gold) * mask


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy, plus ``router_aux_coef`` times the MoE
    layers' summed load-balance loss; labels < 0 are masked."""
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    denom = torch.clamp(mask.sum(), min=1.0)
    if cfg.loss_chunk_vocab:
        hidden, aux = forward_hidden(cfg, params, batch)
        nll = _chunked_ce(cfg, params, hidden, labels, mask)
    else:
        logits, aux = forward(cfg, params, batch)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (logz - gold) * mask
    loss = nll.sum() / denom
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss, {"loss": loss, "ntokens": denom}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def prefill(cfg, params, batch):
    """The prompt's forward: logits (B, S, V). A ``"W"`` layer at S a
    multiple of its window and at least two windows long runs B5, as in
    training. Writes no cache (nor does the reference's)."""
    logits, _ = forward(cfg, params, batch)
    return logits


def init_cache(cfg, batch_size: int, seq_len: int, device="cuda"):
    """Zero decode caches for ``batch_size`` rows of up to ``seq_len``
    tokens in the compute dtype (the SSD state in fp32), plus ``enc_out``
    (B, frames, E) for an encoder-decoder."""
    return _cache_tree(cfg, batch_size, seq_len, resolve_device(device))


def _cache_tree(cfg, batch_size: int, seq_len: int, dev: torch.device):
    dtype = _dtype(cfg.compute_dtype)
    cache = T.init_cache(cfg, batch_size, seq_len, dtype, dev)
    if cfg.encoder is not None:
        cache["enc_out"] = torch.zeros(
            (batch_size, cfg.encoder.num_frames, cfg.d_model), dtype=dtype,
            device=dev)
    return cache


def populate_encoder_cache(cfg, params, cache, frames):
    """Encoder-decoder serving: the encoder runs once over ``frames`` (B,
    T, E), and each decoder layer's cross-attention keys and values
    ``enc_out @ wk`` and ``enc_out @ wv`` go into its ``cross_kv``
    entries; writes ``cache`` in place and returns it."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    enc_out = T.apply_encoder(cfg, T.sub(params, "encoder"),
                              frames.to(_dtype(cfg.compute_dtype)))
    b, t, _ = enc_out.shape
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    for gi, g in enumerate(T.layer_groups(cfg)):
        prefix = f"layers/{gi}"
        for i, p in enumerate(T._layers(params, prefix)):
            for j, w in (("0", "cross/wk"), ("1", "cross/wv")):
                cache[f"{prefix}/cross_kv/{j}"][i].copy_(
                    (enc_out @ p[w]).reshape(b, t, hkv, d))
    cache["enc_out"].copy_(enc_out)
    return cache


def decode_step(cfg, params, cache, tokens, pos):
    """One decode step: ``tokens`` (B, 1) integer, ``pos`` (B,) integer
    on the device, each row's index of its new token. Returns (logits
    (B, 1, V), cache), the cache written in place."""
    x = _embed(cfg, params, tokens)
    x = T.decode_stack(cfg, params, x, cache, pos)
    x = L.apply_norm(cfg, x, T.sub(params, "ln_final"))
    return _unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# dry-run input specs
# ---------------------------------------------------------------------------


def input_specs(cfg, shape, round_spec=None, device="meta"):
    """Stand-ins for every model input of (cfg, shape), the reference's
    keys, shapes and dtypes: on the meta device by default (nothing is
    allocated), or on ``device`` inside ``launch.census`` (fake tensors).

    train:   one round's batch, leaves (S, K, b_local, text_len):
             ``tokens``, ``labels``, plus ``frames`` (S, K, b, frames, E)
             or ``patches`` (S, K, b, prefix, E) where the config has an
             encoder or a prefix;
    prefill: the request batch ``tokens`` (B, text_len) and the same
             stub inputs (B, ..., E);
    decode:  ``tokens`` (B, 1), ``pos`` (B,) and ``cache``, the flat dict
             of ``init_cache`` at the shape's seq_len.
    """
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    i32 = torch.int32
    cdt = _dtype(cfg.compute_dtype)
    text_len = shape.seq_len - cfg.num_prefix_tokens

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=dev)

    def stubs(lead):
        out = {}
        if cfg.encoder is not None:
            out["frames"] = sds(lead + (cfg.encoder.num_frames, cfg.d_model),
                                cdt)
        if cfg.num_prefix_tokens:
            out["patches"] = sds(lead + (cfg.num_prefix_tokens, cfg.d_model),
                                 cdt)
        return out

    if shape.kind == "train":
        assert round_spec is not None
        s, k, bl = (round_spec.num_sampled, round_spec.local_steps,
                    round_spec.local_batch)
        assert s * k * bl == shape.global_batch, (s, k, bl,
                                                  shape.global_batch)
        return {"tokens": sds((s, k, bl, text_len), i32),
                "labels": sds((s, k, bl, text_len), i32),
                **stubs((s, k, bl))}
    if shape.kind == "prefill":
        return {"tokens": sds((shape.global_batch, text_len), i32),
                **stubs((shape.global_batch,))}
    # decode: one new token against a seq_len-sized cache
    b = shape.global_batch
    return {"tokens": sds((b, 1), i32), "pos": sds((b,), i32),
            "cache": _cache_tree(cfg, b, shape.seq_len, dev)}
