"""Synthetic federated LM token shards with a heterogeneity knob (the
JAX package's ``data/synthetic_lm.py``, its numpy host path).

Each client draws tokens from a client-specific unigram mixture: a shared
zipf background blended with a client-private vocabulary slab, plus an
every-other-token ``prev + shift`` structure. The draws are numpy from
the caller's generator, so both packages see the same tokens. The
scanned engine's device batch function is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLMFederated:
    """N clients of synthetic token streams over a ``vocab_size``
    vocabulary; ``heterogeneity`` is the share of client-private tokens."""

    def __init__(self, num_clients: int, vocab_size: int, seq_len: int, *,
                 heterogeneity: float = 0.8, seed: int = 0):
        self.num_clients = num_clients
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.heterogeneity = heterogeneity
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        self.background = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.slices = np.array_split(np.arange(vocab_size), num_clients)
        self.shifts = rng.integers(1, 7, size=num_clients)

    def _client_sample(self, cid: int, shape, rng) -> np.ndarray:
        n = int(np.prod(shape))
        het = self.heterogeneity
        use_private = rng.random(n) < het
        sl = self.slices[cid]
        private = sl[rng.integers(0, len(sl), size=n)]
        shared = rng.choice(self.vocab_size, size=n, p=self.background)
        tokens = np.where(use_private, private, shared)
        tokens = tokens.reshape(-1, shape[-1])
        n_odd = tokens[:, 1::2].shape[1]
        tokens[:, 1::2] = (
            tokens[:, 0::2][:, :n_odd] + self.shifts[cid]
        ) % self.vocab_size
        return tokens.reshape(shape).astype(np.int32)

    def round_batches(self, ids: np.ndarray, K: int, b: int, rng,
                      device="cuda") -> Dict:
        """``{"tokens", "labels"}``, each (S, K, b, seq_len) int64 on
        ``device``."""
        dev = resolve_device(device)
        s = len(ids)
        toks = np.empty((s, K, b, self.seq_len + 1), np.int32)
        for si, cid in enumerate(ids):
            toks[si] = self._client_sample(cid, (K, b, self.seq_len + 1), rng)
        t = torch.from_numpy(toks).long().to(dev)
        return {"tokens": t[..., :-1], "labels": t[..., 1:]}

    def client_sizes(self, ids: np.ndarray) -> np.ndarray:
        """Vocabulary-slab sizes stand in for dataset sizes."""
        return np.asarray([len(self.slices[i]) for i in ids], np.int64)

    def eval_batch(self, batch_size: int, rng, device="cuda") -> Dict:
        """I.i.d. mixture batch for global-model eval."""
        dev = resolve_device(device)
        toks = np.stack([
            self._client_sample(cid, (self.seq_len + 1,), rng)
            for cid in rng.integers(0, self.num_clients, size=batch_size)
        ])
        t = torch.from_numpy(toks).long().to(dev)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
