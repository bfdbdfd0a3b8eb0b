"""Plain PyTorch version of the grouped product (``lax.ragged_dot`` of
the JAX package's ``moe_block_ragged``): one ``@`` a group, the group
ends read back to the host. The tests hold the kernel and the op's CPU
path to it."""
from __future__ import annotations

import torch


def grouped_mm_ref(a, b, ends):
    """a (M, K), b (G, K, N), ends (G,) the groups' cumulative end rows
    -> (M, N): rows ``[ends[g-1], ends[g])`` of a times ``b[g]``, rows
    past ``ends[-1]`` zero, in a's dtype."""
    outs, lo = [], 0
    for g, hi in enumerate(ends.tolist()):
        outs.append(a[lo:hi] @ b[g])
        lo = hi
    if lo < a.shape[0]:
        outs.append(a.new_zeros((a.shape[0] - lo, b.shape[-1])))
    return torch.cat(outs)
