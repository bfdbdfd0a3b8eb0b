"""Model layers of the llama and gemma3 families (the JAX package's
``models/layers.py``, their subset): init helpers, RMSNorm, RoPE, dense
causal and sliding-window GQA attention, the banded local attention of
``"W"`` layers, and the silu- and gelu-gated MLPs.

Conventions as in the reference: activations (B, S, E); q/k/v
(B, S, H, D); parameters are dicts of tensors. The other layers of the
reference (layer norm, flash and MLA attention, MoE, Mamba2) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.swa_attention.ops import swa_attention

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


def dense_attention(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                    scale: Optional[float] = None):
    """Reference (non-chunked) attention as plain tensor code.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). mask_kind in {"causal",
    "sliding", "full"}; "sliding" keeps ``0 <= q_pos - k_pos < window``.
    q positions are [Skv-Sq, Skv). Scores are taken in fp32 (the
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
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)
    rel = q_pos[:, None] - k_pos[None, :]  # >= 0: k not in the future
    if mask_kind == "causal":
        mask = rel >= 0
    elif mask_kind == "sliding":
        mask = (rel >= 0) & (rel < window)
    elif mask_kind == "full":
        mask = None
    else:
        raise NotImplementedError(f"mask {mask_kind!r}: not ported yet")
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def local_attention(q, k, v, *, window: int, scale: Optional[float] = None):
    """Exact sliding-window causal attention in O(S*2W) (the reference's
    ``local_attention_jnp``), the model layer of ``"W"`` attention.

    Needs S % window == 0 and S >= 2*window, else it is dense sliding
    attention. Each window-sized q block attends to its own and the
    previous kv block, masked to the band ``0 <= q_pos - k_pos <
    window``; q is cast to fp32 and scaled before the product, p @ v is
    fp32, and the result is cast to q's dtype once.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s % window != 0 or s < 2 * window:
        return dense_attention(q, k, v, mask_kind="sliding", window=window,
                               scale=scale)
    n_rep = hq // hkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    nb = s // window
    qb = q.reshape(b, nb, window, hq, d).float() * scale
    kb = k.reshape(b, nb, window, hq, d)
    vb = v.reshape(b, nb, window, hq, v.shape[-1])
    # kv context of block i = (block i-1, block i); block -1 is zeros
    prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    kctx = torch.cat([prev, kb], dim=2)  # (B, nb, 2W, H, D)
    prevv = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    vctx = torch.cat([prevv, vb], dim=2)
    s_ = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kctx.float())
    dev = q.device
    q_pos = torch.arange(window, device=dev)[:, None]  # within the block
    k_pos = torch.arange(2 * window, device=dev)[None, :] - window
    rel = q_pos - k_pos
    mask = (rel >= 0) & (rel < window)  # (W, 2W)
    # the first block has no previous block: mask its previous half
    first = ((torch.arange(nb, device=dev) == 0)[:, None, None]
             & (k_pos[None] < 0))  # (nb, 1, 2W)
    neg = torch.full((), NEG_INF, device=dev)
    s_ = torch.where(mask[None, None, None], s_, neg)
    s_ = torch.where(first[:, None, :, :], neg, s_)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vctx.float())
    return out.reshape(b, s, hq, v.shape[-1]).to(q.dtype)


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
    """Causal self-attention over the full sequence (train / prefill):
    full causal for ``"F"`` layers, sliding-window for ``"W"`` layers,
    routed as the reference routes them. A ``"W"`` layer whose sequence
    is a multiple of the window and at least two windows long runs the
    sliding-window kernel (B5, ``kernels.swa_attention``) in its forward
    pass; a shorter or ragged one takes dense sliding attention."""
    b, s, e = x.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if kind not in ("F", "W"):
        raise NotImplementedError(f"attention kind {kind!r}: not ported yet")
    if kind == "F" and s > use_flash_threshold:
        raise NotImplementedError(
            f"sequence length {s} > {use_flash_threshold} takes the "
            f"reference's flash_attention_jnp path: not ported yet")
    q = (x @ p["wq"]).reshape(b, s, h, d)
    k = (x @ p["wk"]).reshape(b, s, hkv, d)
    v = (x @ p["wv"]).reshape(b, s, hkv, d)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kind == "W":
        w = cfg.sliding_window
        # the reference's routing: the band path (B5) on whole windows
        # only; elsewhere dense sliding attention, which rounds p to v's
        # dtype as the reference's does and launches no kernel
        if s % w == 0 and s >= 2 * w:
            out = swa_attention(q, k, v, w)
        else:
            out = dense_attention(q, k, v, mask_kind="sliding", window=w)
    else:
        out = dense_attention(q, k, v, mask_kind="causal")
    return out.reshape(b, s, h * d) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


_MLP_KINDS = ("silu_gated", "gelu_gated")


def init_mlp(cfg, gen, dtype, device):
    """Gated MLP weights w_gate, w_up, w_down (silu- or gelu-gated)."""
    if cfg.mlp_kind not in _MLP_KINDS:
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r}: not ported yet")
    e, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (e, f), dtype, device),
        "w_up": dense_init(gen, (e, f), dtype, device),
        "w_down": dense_init(gen, (f, e), dtype, device),
    }


def mlp_block(cfg, p, x):
    """(act(x W_gate) * x W_up) W_down, act silu or gelu. The gelu is the
    tanh approximation, ``jax.nn.gelu``'s default (torch's default is the
    exact erf form)."""
    if cfg.mlp_kind not in _MLP_KINDS:
        raise NotImplementedError(f"mlp {cfg.mlp_kind!r}: not ported yet")
    gate = x @ p["w_gate"]
    act = (F.silu(gate) if cfg.mlp_kind == "silu_gated"
           else F.gelu(gate, approximate="tanh"))
    return (act * (x @ p["w_up"])) @ p["w_down"]
