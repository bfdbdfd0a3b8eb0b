"""Public model API (the JAX package's ``models/model.py``): init,
forward and the next-token loss that the federated core consumes.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
pytree paths (``embed``, ``ln_final/scale``, ``layers/0/attn/wq``, ...),
so ``repro_torch.convert.params_from_jax`` carries the JAX package's
weights across leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(cfg) -> None:
    if (cfg.mla is not None or cfg.moe is not None
            or cfg.encoder is not None or cfg.num_prefix_tokens):
        raise NotImplementedError(
            f"{cfg.name}: MLA / MoE / encoder / prefix models are not "
            f"ported yet")
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: untied embeddings are not "
                                  f"ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg, gen=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Random initial parameters drawn from ``gen`` (a ``torch.Generator``
    on ``device``; a fresh one seeded with 0 when None). The draws differ
    from the reference's threefry keys; the shapes, dtypes and scales are
    the reference's."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    dtype = _dtype(cfg.param_dtype)
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, dev),
        "ln_final/scale": L.init_norm(cfg, cfg.d_model, dtype, dev)["scale"],
    }
    params.update(T.init_stack(cfg, gen, dtype, dev))
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
    _check_supported(cfg)
    e, h, hkv, d, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    dense = 2 * e + e * h * d + 2 * e * hkv * d + h * d * e + 3 * e * f
    per_kind = {"F": dense, "W": dense}
    if cfg.ssm is not None:
        per_kind["M"] = e + _mamba_params(cfg)  # ln_attn + mamba
        per_kind["Y"] = dense + e + _mamba_params(cfg)  # + ln_mamba
    layers = sum(per_kind[k] for k in cfg.pattern_for_layers())
    return cfg.vocab_size * e + e + layers


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
    return x.to(_dtype(cfg.compute_dtype))


def _unembed(cfg, params, x):
    logits = x @ params["embed"].T.to(x.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward_hidden(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm -> (hidden (B,S,E), aux)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = T.apply_stack(cfg, params, x, positions)
    x = L.apply_norm(cfg, x, T.sub(params, "ln_final"))
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
    for ci, w_chunk in enumerate(params["embed"].split(chunk, dim=0)):
        m, acc, gold = checkpoint(_ce_chunk, hidden, w_chunk, labels, m, acc,
                                  gold, ci * chunk, cfg.logit_softcap,
                                  use_reentrant=False)
    logz = m + torch.log(torch.clamp(acc, min=1e-30))
    return (logz - gold) * mask


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy; labels < 0 are masked."""
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    denom = torch.clamp(mask.sum(), min=1.0)
    if cfg.loss_chunk_vocab:
        hidden, _ = forward_hidden(cfg, params, batch)
        nll = _chunked_ce(cfg, params, hidden, labels, mask)
    else:
        logits, _ = forward(cfg, params, batch)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (logz - gold) * mask
    loss = nll.sum() / denom
    return loss, {"loss": loss, "ntokens": denom}
