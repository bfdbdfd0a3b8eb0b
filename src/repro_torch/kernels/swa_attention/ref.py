"""Plain PyTorch version of the sliding-window attention kernel (the JAX
package's ``kernels/swa_attention/ref.py``): a dense mask over all (q, k)
pairs. The tests hold the kernel and the op's CPU path to it."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, window: int):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) -> (B, Hq, S, D) in q's
    dtype. Keeps the pairs ``0 <= q_pos - k_pos < window``; query head h
    reads kv head ``h // (Hq / Hkv)``; scores, softmax and p @ v in fp32,
    one rounding at the end."""
    s, d = q.shape[2], q.shape[3]
    n_rep = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = (rel >= 0) & (rel < window)
    scores = torch.where(mask[None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
