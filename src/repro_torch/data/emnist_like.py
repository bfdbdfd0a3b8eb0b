"""EMNIST-like federated classification with s%-similarity splits (a
port of the JAX package's ``data/emnist_like.py``).

A 62-class 28x28 task is generated with numpy (class prototypes in two
"writing styles", a shared low-rank background, pixel noise) and split
by the protocol of the paper and Hsu et al. (2019): at s% similarity
each client gets s% i.i.d. data and the rest sorted by label. The same
seed gives the same data, split and batches as the JAX package.

The scanned engine's device protocol keeps the pool and a padded
``(N, max_shard)`` shard-index table on the device; a round's batch is
two chained gathers (shard row, then pool row) at uniform positions
drawn with replacement from the round's data key, as the reference's
``device_batch_fn`` draws them (its host path draws without replacement
where a shard is large enough: another, equally uniform stream).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import streams
from repro_torch.device import resolve_device

NUM_CLASSES = 62
IMG_DIM = 28 * 28


def generate_dataset(num_samples: int, *, seed: int = 0,
                     num_classes: int = NUM_CLASSES,
                     dim: int = IMG_DIM,
                     noise: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic class-structured data: two prototype styles per class,
    a shared low-rank background and pixel noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(num_classes, 2, dim)).astype(np.float32)
    basis = rng.normal(size=(16, dim)).astype(np.float32) / 4.0
    y = rng.integers(0, num_classes, size=num_samples)
    style = rng.integers(0, 2, size=num_samples)
    coef = rng.normal(size=(num_samples, 16)).astype(np.float32)
    x = (
        protos[y, style]
        + coef @ basis
        + noise * rng.normal(size=(num_samples, dim)).astype(np.float32)
    )
    x *= 4.0 / np.sqrt(dim)  # feature norm ~ EMNIST-pixel scale
    return x.astype(np.float32), y.astype(np.int32)


def similarity_split(y: np.ndarray, num_clients: int, similarity_pct: float,
                     seed: int = 0) -> list:
    """Hsu et al.: s% of each client's quota drawn i.i.d., the rest from
    the label-sorted remainder. Returns one index array per client."""
    rng = np.random.default_rng(seed)
    n = len(y)
    idx = rng.permutation(n)
    n_iid = int(n * similarity_pct / 100.0)
    iid_part, sorted_part = idx[:n_iid], idx[n_iid:]
    sorted_part = sorted_part[np.argsort(y[sorted_part], kind="stable")]
    per_client_iid = np.array_split(iid_part, num_clients)
    per_client_sorted = np.array_split(sorted_part, num_clients)
    return [
        np.concatenate([a, b]) for a, b in zip(per_client_iid, per_client_sorted)
    ]


class EmnistLikeFederated:
    """Federated view with the paper's batching: local batch size =
    ``batch_frac`` of the smallest shard (paper: 0.2, 5 steps an epoch).

    The training pool is uploaded to a device once, at its first batch
    there; a round's batches are gathered on that device from the drawn
    indices."""

    def __init__(self, num_clients: int = 100, samples: int = 20_000,
                 similarity_pct: float = 0.0, *, seed: int = 0,
                 test_samples: int = 4_000):
        # one pool, one prototype set, split into train and test
        x, y = generate_dataset(samples + test_samples, seed=seed)
        self.x, self.y = x[:samples], y[:samples]
        self.tx, self.ty = x[samples:], y[samples:]
        self.shards = similarity_split(self.y, num_clients, similarity_pct,
                                       seed=seed + 1)
        self.num_clients = num_clients
        self._pool = {}  # device -> (x, y) tensors

    def _device_pool(self, dev: torch.device):
        if dev not in self._pool:
            self._pool[dev] = (torch.from_numpy(self.x).to(dev),
                               torch.from_numpy(self.y).to(dev))
        return self._pool[dev]

    def round_batches(self, ids: np.ndarray, K: int, b: int, rng,
                      device="cuda") -> Dict:
        """``{"x": (S, K, b, 784) fp32, "y": (S, K, b) int32}`` on
        ``device``. The pool rows are the reference's draws in its order
        (per client ``rng.choice(shard, K*b, replace=len(shard) < K*b)``);
        the rows themselves are gathered on the device."""
        dev = resolve_device(device)
        take = np.empty((len(ids), K * b), np.int64)
        for si, cid in enumerate(ids):
            shard = self.shards[cid]
            take[si] = rng.choice(shard, size=K * b,
                                  replace=len(shard) < K * b)
        px, py = self._device_pool(dev)
        idx = torch.from_numpy(take).to(dev)
        s = len(ids)
        return {"x": px[idx].reshape(s, K, b, IMG_DIM),
                "y": py[idx].reshape(s, K, b)}

    def client_sizes(self, ids: np.ndarray) -> np.ndarray:
        """Per-client dataset sizes (paper §2 weighted aggregation)."""
        return np.asarray([len(self.shards[i]) for i in ids], np.int64)

    def device_data(self, device="cuda") -> Dict:
        """The pool (``"x"`` fp32, ``"y"`` int32), the shard-index table
        (``"shard_idx"``, each shard repeated to the longest, as
        ``np.resize`` pads) and ``"shard_len"`` (int64), on ``device``."""
        dev = resolve_device(device)
        lens = np.asarray([len(s) for s in self.shards], np.int64)
        idx = np.stack([np.resize(s, int(lens.max())) for s in self.shards])
        px, py = self._device_pool(dev)
        return {"x": px, "y": py,
                "shard_idx": torch.from_numpy(idx.astype(np.int64)).to(dev),
                "shard_len": torch.from_numpy(lens).to(dev)}

    def device_batch_fn(self, K: int, b: int):
        """``batch_fn(data, ids, key)``: ``{"x": (S, K, b, 784), "y": (S,
        K, b)}``, client i's rows at positions ``floor(u * len_i)`` of its
        shard (at most ``len_i - 1``), u uniform at ``key``."""

        def batch_fn(data, ids, key):
            s = ids.shape[0]
            u = streams.uniform(key, (s, K, b))
            lens = data["shard_len"].index_select(0, ids)[:, None, None]
            pos = torch.minimum(torch.floor(u * lens.float()).long(),
                                lens - 1)
            take = data["shard_idx"][ids[:, None, None], pos]
            return {"x": data["x"][take], "y": data["y"][take]}

        return batch_fn

    def device_client_sizes(self, device="cuda"):
        """Per-client dataset sizes, ``(N,)`` fp32 on ``device``."""
        return torch.tensor([float(len(s)) for s in self.shards],
                            dtype=torch.float32,
                            device=resolve_device(device))

    def local_batch_size(self, batch_frac: float = 0.2) -> int:
        sizes = [len(s) for s in self.shards]
        return max(1, int(min(sizes) * batch_frac))

    def test_batch(self, device="cuda") -> Dict:
        """The held-out samples, ``{"x": (T, 784), "y": (T,)}`` on
        ``device``."""
        dev = resolve_device(device)
        return {"x": torch.from_numpy(self.tx).to(dev),
                "y": torch.from_numpy(self.ty).to(dev)}
