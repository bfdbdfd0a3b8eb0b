"""The sharded population-store backend (the JAX package's
``dist/store.py``).

``ShardedBackend`` splits the ``(N, ...)`` rows of a leaf into
``num_shards`` contiguous blocks of host tensors, one process's model of
a population spread over parameter-server hosts: shard s holds rows
``[s * ceil(N / n), ...)``, the last shard ragged. A row id routes to
(shard, offset) by integer arithmetic, so a gather or a scatter
decomposes into one slice a shard, as requests to the hosts would.
Registered as ``"sharded"`` (``core.store`` imports this module on the
registry's first use).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.store import StoreBackend, register_store_backend


class ShardedBackend(StoreBackend):
    """Contiguous row blocks across ``num_shards`` host tensors."""

    name = "sharded"

    def __init__(self, num_shards: int = 4):
        assert num_shards >= 1, num_shards
        self.num_shards = int(num_shards)

    def allocate(self, num_rows, shape, dtype):
        block = -(-num_rows // self.num_shards)  # ceil: the last ragged
        shards: List[torch.Tensor] = []
        for s in range(self.num_shards):
            n = max(0, min(block, num_rows - s * block))
            shards.append(torch.zeros((n,) + tuple(shape), dtype=dtype))
        return {"shards": shards, "block": block, "num_rows": num_rows}

    def _route(self, handle, ids):
        """Each shard that ``ids`` touch, with the positions in ``ids``
        and the offsets in the shard."""
        shard_of, local = np.divmod(ids, handle["block"])
        for s in np.unique(shard_of):
            here = np.flatnonzero(shard_of == s)
            yield (handle["shards"][s], torch.from_numpy(here),
                   torch.from_numpy(local[here]))

    def read_rows(self, handle, ids):
        first = handle["shards"][0]
        out = torch.empty((len(ids),) + tuple(first.shape[1:]),
                          dtype=first.dtype)
        for shard, here, local in self._route(handle, ids):
            out.index_copy_(0, here, shard.index_select(0, local))
        return out

    def write_rows(self, handle, ids, rows):
        for shard, here, local in self._route(handle, ids):
            shard.index_copy_(0, local, rows.index_select(0, here))

    def nbytes(self, handle) -> int:
        return sum(int(a.nbytes) for a in handle["shards"])


register_store_backend("sharded", ShardedBackend)
