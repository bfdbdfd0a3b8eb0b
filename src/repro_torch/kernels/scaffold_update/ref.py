"""Plain PyTorch versions of the fused SCAFFOLD kernels (the JAX
package's ``kernels/scaffold_update/ref.py``).

They are what the wrappers run for tensors on the CPU, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

import torch


def scaffold_update_ref(y, g, corr, eta: float):
    """fp32-accumulating corrected step ``y - eta*(g + corr)`` (eq. 3),
    rounded once to ``y``'s dtype."""
    out = y.float() - eta * (g.float() + corr.float())
    return out.to(y.dtype)


def scaffold_momentum_update_ref(y, g, corr, m, eta: float, beta: float):
    """Fused heavy-ball step (the ``momentum`` local solver's):
    ``m' = beta*m + (g + corr)``, ``y' = y - eta*m'``, fp32 accumulation,
    one rounding at the casts back to the operand dtypes."""
    m_new = beta * m.float() + (g.float() + corr.float())
    y_new = (y.float() - eta * m_new).to(y.dtype)
    return y_new, m_new.to(m.dtype)


def scaffold_momentum_update_tree_ref(y, g, corr, m, eta: float,
                                      beta: float):
    """Per-leaf plain version of the packed heavy-ball path; returns
    ``(y', m')`` trees."""
    out = {k: scaffold_momentum_update_ref(y[k], g[k], corr[k], m[k], eta,
                                           beta) for k in y}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def scaffold_local_loop_ref(y, corr, eta_table, A, b, *, m=None,
                            beta: float = 0.0):
    """K-step corrected local loop on the quadratics substrate.

    ``y``: ``(d,)``; ``corr``: ``(d,)`` or None; ``eta_table``: ``(K,)``;
    ``A``: ``(K, bsz, d, d)``; ``b``: ``(K, bsz, d)``; ``m``: ``(d,)``
    heavy-ball slot or None. Returns ``(y_K, m_K | None, losses (K,))``.

    Step k takes the batch means ``Am = mean_b A_k``, ``bm = mean_b b_k``
    in fp32 and computes ``g = 0.5*(Am y + y Am) + bm + corr`` (the
    gradient of the mean of ``0.5 y^T A y + b^T y``), the loss at the
    pre-update ``y``, and ``y <- y - eta[k]*g`` rounded once to y's dtype.
    """
    d = y.shape[0]
    corr32 = (torch.zeros(d, dtype=torch.float32, device=y.device)
              if corr is None else corr.float())
    Am = A.float().mean(dim=1)
    bm = b.float().mean(dim=1)
    eta = torch.as_tensor(eta_table, dtype=torch.float32, device=y.device)
    has_m = m is not None
    mm = m.float() if has_m else None
    losses = []
    for k in range(A.shape[0]):
        y32 = y.float()
        u = Am[k] @ y32
        v = y32 @ Am[k]
        losses.append(0.5 * torch.dot(u, y32) + torch.dot(bm[k], y32))
        g = 0.5 * (u + v) + bm[k] + corr32
        if has_m:
            mm = beta * mm + g
            g = mm
        y = (y32 - eta[k] * g).to(y.dtype)
    return y, mm, torch.stack(losses)
