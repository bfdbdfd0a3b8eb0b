"""Model layers of the ported families (the JAX package's
``models/layers.py``, their subset): init helpers, RMSNorm and layer
norm, RoPE, dense GQA attention under the causal, sliding, prefix and
full masks, the blocked online-softmax attention of long ``"F"``
sequences, the banded local attention of ``"W"`` layers, MLA (multi-head
latent attention), the silu- and gelu-gated MLPs and the plain gelu MLP,
the Mamba2 SSD block of ``"M"`` and ``"Y"`` layers, and the one-token
decode of each attention and of the SSD against its cache.

Conventions as in the reference: activations (B, S, E); q/k/v
(B, S, H, D); parameters are dicts of tensors. A decode cache is a dict
of tensors too (``k``/``v``, ``ckv``/``k_rope``, ``conv``/``state``);
a decode step writes its new entries into it in place, where the
reference returns an updated copy. Positions ``pos`` (B,) are integer
tensors on the device, and every mask and slot is computed there: a
decode step reads no value back to the host. MoE is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.swa_attention.ops import swa_attention

# ---------------------------------------------------------------------------
# init helpers (torch.Generator in place of the reference's jax keys)
# ---------------------------------------------------------------------------


def dense_init(gen, shape, dtype, device, scale: Optional[float] = None):
    """Normal(0, scale) weights of a (d_in, d_out) matrix, ``scale``
    1/sqrt(d_in) unless given, drawn in fp32 and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    scale = (1.0 / math.sqrt(shape[0])) if scale is None else scale
    return (w * scale).to(dtype)


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


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Layer norm, in fp32 (the reference's ``layer_norm``)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def apply_norm(cfg, x, p):
    """The config's norm of x with parameters ``p``."""
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def init_norm(cfg, dim, dtype, device):
    """Norm parameters: layer norm's scale is ones and its bias zeros;
    RMSNorm stores its scale as (w - 1), zeros."""
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    """RoPE inverse frequencies, fp32, (head_dim / 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions, head_dim: int, theta: float):
    """cos and sin of the RoPE angles at ``positions`` (B, S) integer,
    each (B, S, 1, head_dim / 2) fp32."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs  # (B, S, d/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x, positions, theta: float, table=None):
    """x: (B, S, H, D), positions: (B, S) integer. ``table``, the
    ``rope_table`` of these positions at D, when the caller has it."""
    cos, sin = (rope_table(positions, x.shape[-1], theta) if table is None
                else table)
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


def _mask(mask_kind: str, q_pos, k_pos, prefix_len: int = 0,
            window: int = 0):
    """The (Sq, Skv) boolean mask of ``mask_kind`` (None for "full"):
    "causal" keeps k not in q's future, "sliding" also ``q_pos - k_pos <
    window``, "prefix" is bidirectional over ``k_pos < prefix_len`` and
    causal after it."""
    rel = q_pos[:, None] - k_pos[None, :]  # >= 0: k not in the future
    if mask_kind == "causal":
        return rel >= 0
    if mask_kind == "sliding":
        return (rel >= 0) & (rel < window)
    if mask_kind == "prefix":
        return (rel >= 0) | (k_pos[None, :] < prefix_len)
    if mask_kind == "full":
        return None
    raise ValueError(mask_kind)


def dense_attention(q, k, v, *, mask_kind: str = "causal", prefix_len: int = 0,
                    window: int = 0, scale: Optional[float] = None):
    """Reference (non-chunked) attention as plain tensor code.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). mask_kind in {"causal",
    "sliding", "prefix", "full"} (``_mask``). q positions are [Skv-Sq,
    Skv). Scores are taken in fp32 (the reference's
    ``preferred_element_type``), the softmax is fp32 and its
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
    mask = _mask(mask_kind, q_pos, k_pos, prefix_len, window)
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# an "F" layer longer than this many tokens takes ``flash_attention``, over
# kv blocks of ``FLASH_BLOCK_KV`` (the reference's defaults)
FLASH_THRESHOLD = 2048
FLASH_BLOCK_KV = 1024


def _flash_block(q32, kblk, vblk, o, m, l, mask):
    """One kv block of the online softmax: the scores of fp32 q (scaled)
    against the block, masked, folded into the carry ``(o, m, l)``. GQA
    groups q's heads by their kv head (head h reads kv head h // n_rep,
    as ``_repeat_kv``) instead of repeating k and v."""
    b, sq, hq, d = q32.shape
    hkv = kblk.shape[2]
    qg = q32.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kblk.float()).reshape(
        b, hq, sq, kblk.shape[1])  # (B, H, Sq, block)
    if mask is not None:
        s = torch.where(mask[None, None], s,
                        torch.full((), NEG_INF, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bgrqk,bkgd->bgrqd",
                      p.reshape(b, hkv, hq // hkv, sq, -1), vblk.float())
    o_new = o * alpha[..., None] + pv.reshape(b, hq, sq, -1)
    return o_new, m_new, l_new


def flash_attention(q, k, v, *, mask_kind: str = "causal", prefix_len: int = 0,
                    block_kv: int = FLASH_BLOCK_KV,
                    scale: Optional[float] = None):
    """Online-softmax attention over kv blocks of ``block_kv`` (the
    reference's ``flash_attention_jnp``): never builds the (Sq, Skv)
    scores. Semantics of ``dense_attention`` for mask_kind in {"causal",
    "prefix", "full"}; a Skv that is not a multiple of the block takes
    ``dense_attention``, as the reference does.

    q is cast to fp32 and scaled before the product, the carry and p @ v
    are fp32, and the output ``o / max(l, 1e-30)`` is cast to q's dtype
    once. Each block is recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's remat of its scan body),
    so the backward holds one block's scores at a time; without autograd
    the checkpoint just runs the block."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if skv % block_kv != 0:
        return dense_attention(q, k, v, mask_kind=mask_kind,
                               prefix_len=prefix_len, scale=scale)
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    dev = q.device
    q32 = q.float() * scale
    q_pos = torch.arange(sq, device=dev) + (skv - sq)
    o = torch.zeros((b, hq, sq, v.shape[-1]), dtype=torch.float32,
                    device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    for lo in range(0, skv, block_kv):
        k_pos = torch.arange(lo, lo + block_kv, device=dev)
        mask = _mask(mask_kind, q_pos, k_pos, prefix_len)
        # the block draws no random numbers: no RNG state to keep
        o, m, l = checkpoint(_flash_block, q32, k[:, lo:lo + block_kv],
                             v[:, lo:lo + block_kv], o, m, l, mask,
                             use_reentrant=False, preserve_rng_state=False)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


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


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None):
    """One-token attention: q (B, 1, H, D) against a cache (B, C, Hkv,
    D), ``pos`` (B,) the new token's index. GQA is a grouped einsum (q's
    heads grouped by their kv head), not a repeated cache. q is scaled
    in its dtype and cast to the cache's; the scores and p @ v are fp32
    (the reference's ``preferred_element_type``), p cast to v's dtype
    first. A ring-buffer cache (``C == window``) holds the last
    ``window`` tokens once ``pos >= window``; otherwise the slots after
    ``pos`` are masked."""
    b, _, hq, d = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = hq // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    qg = (q * torch.full((), scale, dtype=q.dtype, device=q.device)).reshape(
        b, 1, hkv, n_rep, d).to(k_cache.dtype)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k_cache.float())
    slot = torch.arange(c, device=q.device)[None, :]
    at = pos[:, None]
    valid = slot <= at
    if window and c == window:
        valid = valid | (at >= window)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p.float(), v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _write_rows(bufs, news, slot):
    """buf[i, slot[i]] = new[i] for every row i of each pair, in place:
    each ``buf`` (B, C, ...), its ``new`` (B, ...), ``slot`` (B,) integer
    on the device."""
    b, c = bufs[0].shape[:2]
    rows = torch.arange(b, device=slot.device) * c + slot.long()
    for buf, new in zip(bufs, news):
        buf.view(b * c, *buf.shape[2:]).index_copy_(0, rows,
                                                    new.to(buf.dtype))


def init_attention(cfg, gen, dtype, device):
    """GQA projection weights wq, wk, wv, wo."""
    e, h, hkv, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (e, h * d), dtype, device),
        "wk": dense_init(gen, (e, hkv * d), dtype, device),
        "wv": dense_init(gen, (e, hkv * d), dtype, device),
        "wo": dense_init(gen, (h * d, e), dtype, device),
    }


def attention_block(cfg, p, x, positions, *, kind: str, prefix_len: int = 0,
                    use_flash_threshold: int = FLASH_THRESHOLD):
    """Self-attention over the full sequence (train / prefill), routed as
    the reference routes it. A ``"W"`` layer whose sequence is a multiple
    of the window and at least two windows long runs the sliding-window
    kernel (B5, ``kernels.swa_attention``) in its forward pass; a shorter
    or ragged one takes dense sliding attention. Any other layer is
    causal, or a prefix LM's mask when ``prefix_len`` > 0: dense up to
    ``use_flash_threshold`` tokens, ``flash_attention`` beyond."""
    b, s, e = x.shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
        mask_kind = "prefix" if prefix_len else "causal"
        attend = flash_attention if s > use_flash_threshold else \
            dense_attention
        out = attend(q, k, v, mask_kind=mask_kind, prefix_len=prefix_len)
    return out.reshape(b, s, h * d) @ p["wo"]


def attention_decode(cfg, p, x, cache, pos, *, kind: str, rope=None):
    """One-token self-attention, x (B, 1, E) at ``pos`` (B,): RoPE at
    ``pos`` (``rope``, its ``rope_table`` at head_dim, when the caller
    shares one across layers), the new k and v written into ``cache``
    (``k``, ``v``: (B, C, Hkv, D)) in place, at ``pos % C`` in a ``"W"``
    layer's ring buffer (``C == window``) and at ``pos`` otherwise; then
    ``decode_attention`` over the cache."""
    b = x.shape[0]
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, d)
    k = (x @ p["wk"]).reshape(b, 1, hkv, d)
    v = (x @ p["wv"]).reshape(b, 1, hkv, d)
    if rope is None:
        rope = rope_table(pos[:, None], d, cfg.rope_theta)
    q = apply_rope(q, None, cfg.rope_theta, table=rope)
    k = apply_rope(k, None, cfg.rope_theta, table=rope)
    c = cache["k"].shape[1]
    window = cfg.sliding_window if kind == "W" else 0
    slot = pos % c if (window and c == window) else pos
    _write_rows((cache["k"], cache["v"]), (k[:, 0], v[:, 0]), slot)
    out = decode_attention(q, cache["k"], cache["v"], pos, window=window)
    return out.reshape(b, 1, h * d) @ p["wo"]


def init_attention_cache(cfg, batch, seq_len, dtype, kind: str, device):
    """Zero k and v caches (B, C, Hkv, D): C is ``min(window, seq_len)``
    for a ``"W"`` layer (a ring buffer once the window is full), else
    ``seq_len``."""
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    c = min(cfg.sliding_window, seq_len) if kind == "W" else seq_len
    return {k: torch.zeros((batch, c, hkv, d), dtype=dtype, device=device)
            for k in ("k", "v")}


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3)
# ---------------------------------------------------------------------------


def init_mla(cfg, gen, dtype, device):
    """MLA's leaves, the reference's: the q path's down-projection, its
    norm and up-projection (``wq_a``, ``q_norm/scale``, ``wq_b``), the
    kv latent's down-projection and norm (``wkv_a``, ``kv_norm/scale``),
    the shared RoPE key (``wk_rope``), the latent's up-projections to the
    per-head keys and values (``wk_b``, ``wv_b``) and ``wo``."""
    m = cfg.mla
    e, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (e, m.q_lora_rank), dtype, device),
        "q_norm/scale": torch.zeros((m.q_lora_rank,), dtype=dtype,
                                    device=device),
        "wq_b": dense_init(gen, (m.q_lora_rank, h * qk), dtype, device),
        "wkv_a": dense_init(gen, (e, m.kv_lora_rank), dtype, device),
        "kv_norm/scale": torch.zeros((m.kv_lora_rank,), dtype=dtype,
                                     device=device),
        "wk_rope": dense_init(gen, (e, m.qk_rope_head_dim), dtype, device),
        "wk_b": dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                           dtype, device),
        "wv_b": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dtype,
                           device),
        "wo": dense_init(gen, (h * m.v_head_dim, e), dtype, device),
    }


def mla_block(cfg, p, x, positions, *, prefix_len: int = 0):
    """MLA self-attention over the full sequence (train / prefill): the
    latent expanded to per-head keys and values. q and k have head dim
    ``nope + rope`` and v ``v_head_dim``; the scale is ``1/sqrt(nope +
    rope)``. Dense up to ``FLASH_THRESHOLD`` tokens, ``flash_attention``
    beyond, as the reference routes it."""
    m = cfg.mla
    b, s, e = x.shape
    h = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    cq = rms_norm(x @ p["wq_a"], p["q_norm/scale"])
    q = (cq @ p["wq_b"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rms_norm(x @ p["wkv_a"], p["kv_norm/scale"])  # (B, S, R)
    k_nope = (ckv @ p["wk_b"]).reshape(b, s, h, dn)
    v = (ckv @ p["wv_b"]).reshape(b, s, h, dv)
    k_rope = apply_rope((x @ p["wk_rope"]).reshape(b, s, 1, dr), positions,
                        cfg.rope_theta).expand(b, s, h, dr)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    mask_kind = "prefix" if prefix_len else "causal"
    attend = flash_attention if s > FLASH_THRESHOLD else dense_attention
    out = attend(q_full, k_full, v, mask_kind=mask_kind,
                 prefix_len=prefix_len, scale=1.0 / math.sqrt(dn + dr))
    return out.reshape(b, s, h * dv) @ p["wo"]


def mla_decode(cfg, p, x, cache, pos, rope=None):
    """One-token MLA in the absorbed form: the cache holds only the
    normed latent ``ckv`` (B, C, R) and the RoPE key ``k_rope`` (B, C,
    rope), both written at ``pos`` in place. ``wk_b`` is folded into q
    (scores ``(q_nope wk_b) ckv^T + q_rope k_rope^T``) and ``wv_b`` into
    the output (``(p ckv) wv_b``): the per-head keys and values are never
    built. The cache is contracted in fp32, q cast to its dtype first,
    p to its dtype before the second product. ``rope``: the
    ``rope_table`` at ``pos`` and the rope dim, when the caller has it."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    cq = rms_norm(x @ p["wq_a"], p["q_norm/scale"])
    q = (cq @ p["wq_b"]).reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    if rope is None:
        rope = rope_table(pos[:, None], dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, None, cfg.rope_theta, table=rope)
    ckv_new = rms_norm(x @ p["wkv_a"], p["kv_norm/scale"]).reshape(b, r)
    kr_new = apply_rope((x @ p["wk_rope"]).reshape(b, 1, 1, dr), None,
                        cfg.rope_theta, table=rope).reshape(b, dr)
    ckv, kr = cache["ckv"], cache["k_rope"]
    _write_rows((ckv, kr), (ckv_new, kr_new), pos)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["wk_b"].reshape(r, h, dn))
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat.to(ckv.dtype).float(),
                         ckv.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.to(kr.dtype).float(),
                          kr.float())
    s = (s_lat + s_rope) * (1.0 / math.sqrt(dn + dr))
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] <= \
        pos[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhqk,bkr->bqhr", pattn.float(), ckv.float())
    out = torch.einsum("bqhr,rhd->bqhd", o_lat.to(x.dtype),
                       p["wv_b"].reshape(r, h, dv))
    return out.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"]


def init_mla_cache(cfg, batch, seq_len, dtype, device):
    """Zero latent caches: ``ckv`` (B, C, kv_lora_rank) and ``k_rope``
    (B, C, qk_rope_head_dim)."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, seq_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, seq_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg, gen, dtype, device):
    """MLP weights: w_up, w_down for the plain ``"gelu"`` MLP; w_gate,
    w_up, w_down for the silu- and gelu-gated ones."""
    e, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {"w_up": dense_init(gen, (e, f), dtype, device),
                "w_down": dense_init(gen, (f, e), dtype, device)}
    return {
        "w_gate": dense_init(gen, (e, f), dtype, device),
        "w_up": dense_init(gen, (e, f), dtype, device),
        "w_down": dense_init(gen, (f, e), dtype, device),
    }


def mlp_block(cfg, p, x):
    """gelu(x W_up) W_down for ``"gelu"``; (act(x W_gate) * x W_up)
    W_down, act silu or gelu, for the gated kinds. The gelu is the tanh
    approximation, ``jax.nn.gelu``'s default (torch's default is the
    exact erf form)."""
    if cfg.mlp_kind == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    gate = x @ p["w_gate"]
    act = (F.silu(gate) if cfg.mlp_kind == "silu_gated"
           else F.gelu(gate, approximate="tanh"))
    return (act * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def init_mamba(cfg, gen, dtype, device):
    """Mamba2 parameters, the reference's leaves: the in- and
    out-projections, the depthwise conv, the gated output norm in
    ``dtype``; ``a_log``, ``dt_bias`` and ``d_skip`` in fp32 whatever
    ``dtype`` is."""
    sm = cfg.ssm
    e = cfg.d_model
    di, h, n, g = sm.d_inner(e), sm.n_heads(e), sm.d_state, sm.n_groups
    conv_dim = di + 2 * g * n
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, (e, 2 * di + 2 * g * n + h), dtype, device),
        "conv_w": dense_init(gen, (sm.conv_kernel, conv_dim), dtype, device,
                             scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "out_norm/scale": torch.zeros((di,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (di, e), dtype, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, x (B, S, C), w (K, C): the reference's sum
    of K shifted products, each rounded to the parameters' dtype (a
    ``conv1d`` accumulates in fp32 and rounds bf16 otherwise)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _ssd_chunked(xh, dt, a_log, bmat, cmat, d_skip, chunk: int):
    """SSD (state-space duality) chunked scan, the reference's arithmetic.

    xh (B, S, H, P), dt (B, S, H) after the softplus, bmat and cmat
    (B, S, N) (one group), a_log (H,). The chunk length is ``min(chunk,
    S)``, halved until it divides S. Returns y (B, S, H, P) and the final
    state (B, H, N, P)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    while s % l != 0:
        l //= 2
    nc = s // l
    a = -torch.exp(a_log)  # (H,), negative
    xc = xh.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h)
    bc = bmat.reshape(b, nc, l, n)
    cc = cmat.reshape(b, nc, l, n)
    seg = torch.cumsum((dt * a).reshape(b, nc, l, h), dim=2)  # log-decay
    total = seg[:, :, -1:, :]  # (B, nc, 1, H)

    # intra-chunk: quadratic within a chunk, causal
    cb = torch.einsum("bcln,bcmn->bclm", cc, bc)  # (B, nc, L, L)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B, nc, L, L, H)
    # mask BEFORE the exp: the upper triangle is exp(+large) = inf, and
    # inf * 0 in a later where still poisons the backward with NaNs
    diff = torch.where(mask, diff, torch.full((), -math.inf,
                                              device=xh.device))
    m = cb[..., None] * torch.exp(diff) * dtc[:, :, None, :, :]
    m = torch.where(mask, m, torch.zeros((), device=xh.device))
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", m, xc)

    # each chunk's state: decay from a step to its chunk's end
    state_decay = torch.exp(total - seg)  # (B, nc, L, H)
    sc = torch.einsum("bcln,bclh,bclhp->bchnp", bc, dtc * state_decay, xc)

    # inter-chunk recurrence, a loop over the chunks (the reference's scan)
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B, nc, H)
    state = torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    s_prevs = torch.stack(entering, dim=1)  # (B, nc, H, N, P)

    # the state entering each chunk, read out within it
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", cc, torch.exp(seg),
                           s_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y + xh * d_skip[None, None, :, None], state


def mamba_block(cfg, p, x):
    """Full-sequence Mamba2 forward, x (B, S, E) -> (B, S, E). The SSD
    runs in fp32: x, B and C are cast up and ``dt_bias`` is added in
    fp32, as the reference does."""
    sm = cfg.ssm
    b, s, e = x.shape
    di, h, n, g = sm.d_inner(e), sm.n_heads(e), sm.d_state, sm.n_groups
    proj = x @ p["w_in"]  # (B, S, 2 di + 2 g n + h)
    z, xin, bc, dt = torch.split(proj, [di, di, 2 * g * n, h], dim=-1)
    conv_out = _causal_conv(torch.cat([xin, bc], dim=-1), p["conv_w"],
                            p["conv_b"])
    xin, bmat, cmat = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    xh = xin.reshape(b, s, h, sm.head_dim)
    y, _ = _ssd_chunked(xh.float(), dt, p["a_log"], bmat.float(),
                        cmat.float(), p["d_skip"], sm.chunk_size)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm/scale"])
    return y @ p["w_out"]


def mamba_decode(cfg, p, x, cache, pos):
    """One-token Mamba2 step, x (B, 1, E): the conv over the cached
    history (``conv`` (B, K-1, C), in the compute dtype) and the new
    input; the state (``state`` (B, H, N, P), fp32) decayed by ``exp(dt
    a)`` and fed ``dt B x``; y read out by C, plus the skip. Both cache
    entries are written in place; ``pos`` is unused (the recurrence
    carries the position)."""
    sm = cfg.ssm
    b, _, e = x.shape
    di, h, n, g = sm.d_inner(e), sm.n_heads(e), sm.d_state, sm.n_groups
    proj = x[:, 0] @ p["w_in"]  # (B, 2 di + 2 g n + h)
    z, xin, bc, dt = torch.split(proj, [di, di, 2 * g * n, h], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)  # (B, C)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"])
                      + p["conv_b"])
    xin, bmat, cmat = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["a_log"]))  # (B, H)
    xh = xin.reshape(b, h, sm.head_dim).float()
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", bmat.float(), dt, xh)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), state)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm/scale"])
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return (y @ p["w_out"])[:, None]


def init_mamba_cache(cfg, batch, dtype, device):
    """Zero Mamba2 caches: the conv history ``conv`` (B, K-1, C) in
    ``dtype`` and the SSD state ``state`` (B, H, N, P) in fp32."""
    sm = cfg.ssm
    e = cfg.d_model
    conv_dim = sm.d_inner(e) + 2 * sm.n_groups * sm.d_state
    return {"conv": torch.zeros((batch, sm.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, sm.n_heads(e), sm.d_state,
                                  sm.head_dim), dtype=torch.float32,
                                 device=device)}
