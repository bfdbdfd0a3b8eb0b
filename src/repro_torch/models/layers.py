"""Model layers of the llama family (the JAX package's
``models/layers.py``, its llama subset): init helpers, RMSNorm, RoPE,
dense causal GQA attention and the silu-gated MLP.

Conventions as in the reference: activations (B, S, E); q/k/v
(B, S, H, D); parameters are dicts of tensors. The other layers of the
reference (layer norm, sliding-window, flash and MLA attention, MoE,
Mamba2) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers (torch.Generator in place of the reference's jax keys)
# ---------------------------------------------------------------------------


def dense_init(gen, shape, dtype, device):
    """Normal(0, 1/fan_in) weights of a (d_in, d_out) matrix, drawn in fp32
    and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(shape[0]))).to(dtype)


def embed_init(gen, shape, dtype, device):
    """Normal(0, 0.02) embedding table."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with the reference's ``(1 + w)`` scale, in fp32."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dt)


def apply_norm(cfg, x, p):
    """The config's norm (RMSNorm) of x with parameters ``p``."""
    if cfg.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm_kind!r}: not ported yet")
    return rms_norm(x, p["scale"])


def init_norm(cfg, dim, dtype, device):
    """RMSNorm parameters: the scale is stored as (w - 1), zeros."""
    if cfg.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm_kind!r}: not ported yet")
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    """RoPE inverse frequencies, fp32, (head_dim / 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D), positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dense_attention(q, k, v, *, mask_kind: str = "causal",
                    scale: Optional[float] = None):
    """Reference (non-chunked) attention as plain tensor code.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). mask_kind in {"causal",
    "full"}. q positions are [Skv-Sq, Skv). Scores are taken in fp32 (the
    reference's ``preferred_element_type``), the softmax is fp32 and its
    probabilities are cast to v's dtype for the second product.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * scale
    if mask_kind == "causal":
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)
        mask = (q_pos[:, None] - k_pos[None, :]) >= 0
        scores = torch.where(mask[None, None], scores,
                             torch.full((), NEG_INF, device=q.device))
    elif mask_kind != "full":
        raise NotImplementedError(f"mask {mask_kind!r}: not ported yet")
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def init_attention(cfg, gen, dtype, device):
    """GQA projection weights wq, wk, wv, wo."""
    e, h, hkv, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (e, h * d), dtype, device),
        "wk": dense_init(gen, (e, hkv * d), dtype, device),
        "wv": dense_init(gen, (e, hkv * d), dtype, device),
        "wo": dense_init(gen, (h * d, e), dtype, device),
    }


def attention_block(cfg, p, x, positions, *, kind: str,
                    use_flash_threshold: int = 2048):
    """Causal self-attention over the full sequence (train / prefill)."""
    b, s, e = x.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if kind != "F":
        raise NotImplementedError(f"attention kind {kind!r}: not ported yet")
    if s > use_flash_threshold:
        raise NotImplementedError(
            f"sequence length {s} > {use_flash_threshold} takes the "
            f"reference's flash_attention_jnp path: not ported yet")
    q = (x @ p["wq"]).reshape(b, s, h, d)
    k = (x @ p["wk"]).reshape(b, s, hkv, d)
    v = (x @ p["wv"]).reshape(b, s, hkv, d)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = dense_attention(q, k, v, mask_kind="causal")
    return out.reshape(b, s, h * d) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg, gen, dtype, device):
    """silu-gated MLP weights w_gate, w_up, w_down."""
    if cfg.mlp_kind != "silu_gated":
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r}: not ported yet")
    e, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (e, f), dtype, device),
        "w_up": dense_init(gen, (e, f), dtype, device),
        "w_down": dense_init(gen, (f, e), dtype, device),
    }


def mlp_block(cfg, p, x):
    """(silu(x W_gate) * x W_up) W_down."""
    if cfg.mlp_kind != "silu_gated":
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r}: not ported yet")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
