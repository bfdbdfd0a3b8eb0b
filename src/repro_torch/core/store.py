"""The population client store over the dense host backend (the JAX
package's ``core/store.py``: ``ClientStateStore``).

One instance holds one per-client state tree for all N clients as
``(N, ...)`` tensors in host memory, zeros for clients never sampled:
the control variates ``c_i``, or a stateful local solver's slots as one
flat row family (``core.tree.tree_flatten_slots``: fp32 ``"m/<leaf>"``
and ``"v/<leaf>"`` rows, and adam's step counter as an ``(N,)`` int32
row ``"t"``). The cohort is gathered before a round and scattered back
after it. The other backends (``memmap``, ``sharded``) and the tiered
store are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_gather, tree_scatter


class ClientStateStore:
    """Host store of one per-client state tree for all N clients.

    Ownership is copy-on-gather: ``gather`` returns freshly allocated
    rows the caller owns, and ``scatter`` copies values in.
    """

    def __init__(self, template, num_clients: int, backend: str = "dense"):
        if backend not in ("", "dense"):
            raise NotImplementedError(f"store backend {backend!r}: not "
                                      f"ported yet")
        self.num_clients = num_clients
        self._rows = {k: torch.zeros((num_clients,) + tuple(v.shape),
                                     dtype=v.dtype)
                      for k, v in template.items()}
        self.row_nbytes = sum(v.numel() * v.element_size()
                              for v in template.values())

    def gather(self, ids):
        """Rows ``ids`` (an array, a list or a tensor on any device) as a
        dict of owned host ``(len(ids), ...)`` tensors."""
        return tree_gather(self._rows, ids)

    def scatter(self, ids, new) -> None:
        """Write rows ``ids`` (values are copied in, from any device)."""
        tree_scatter(self._rows, ids, new)

    @property
    def rows(self):
        """The ``(N, ...)`` host tensors themselves, not copied: read them,
        write through :meth:`scatter`."""
        return self._rows

    @property
    def population_nbytes(self) -> int:
        """Bytes the N-row population occupies in host memory."""
        return self.num_clients * self.row_nbytes

    def close(self) -> None:
        self._rows = {}
