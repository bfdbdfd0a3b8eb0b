"""Simulated quadratic clients (paper §7.2), a port of the JAX package's
``data/quadratics.py``.

Clients minimise f_i(x) = 1/2 x^T A_i x + b_i^T x. Everything is built
with numpy from the seed, so the same seed gives the same ``A`` and ``b``
as the JAX package. Batches carry the owning client's (A_i, b_i); σ=0
(full batch) as in §7.2.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def quadratic_loss(params, batch) -> Tuple[torch.Tensor, Dict]:
    """params: {"x": (d,)}; batch: {"A": (b,d,d), "b": (b,d)}."""
    x = params["x"]
    quad = 0.5 * torch.einsum("bij,i,j->b", batch["A"], x, x)
    lin = torch.einsum("bi,i->b", batch["b"], x)
    loss = torch.mean(quad + lin)
    return loss, {"loss": loss}


# the batch-mean gradient sym(mean A) x + mean b is expressible inside the
# K-step kernel; core.controller.make_grad_fn propagates this marker and
# core.local_solver.megakernel_incompatibility gates the dispatch on it
quadratic_loss.megakernel_grad = "quadratic"


def global_optimum(A_list, b_list):
    """argmin of the mean objective: solve(mean A, -mean b)."""
    A = np.mean(A_list, axis=0)
    b = np.mean(b_list, axis=0)
    return np.linalg.solve(A, -b)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class QuadraticDataset:
    """Federated dataset of N quadratic clients (σ=0: every local step sees
    the client's full objective)."""

    def __init__(self, A_list: np.ndarray, b_list: np.ndarray):
        self.A = np.asarray(A_list, np.float32)  # (N, d, d)
        self.b = np.asarray(b_list, np.float32)  # (N, d)
        self.num_clients, self.dim = self.b.shape
        self.x_star = global_optimum(self.A, self.b)
        f = lambda x: float(
            0.5 * x @ self.A.mean(0) @ x + self.b.mean(0) @ x
        )
        self.f_star = f(self.x_star)

    def round_batches(self, ids: np.ndarray, K: int, b: int, rng,
                      device="cuda") -> Dict:
        """``{"A": (S, K, b, d, d), "b": (S, K, b, d)}`` on ``device``.

        The K and b dimensions are broadcast views of one (A_i, b_i) upload
        per client (the JAX package materialises them; the values are the
        same)."""
        dev = resolve_device(device)
        s = len(ids)
        A = torch.from_numpy(self.A[ids]).to(dev)
        bb = torch.from_numpy(self.b[ids]).to(dev)
        return {
            "A": A[:, None, None].expand(s, K, b, self.dim, self.dim),
            "b": bb[:, None, None].expand(s, K, b, self.dim),
        }

    def client_sizes(self, ids: np.ndarray) -> np.ndarray:
        """Uniform: each simulated client owns one full objective."""
        return np.ones(len(ids), np.int64)

    def f(self, x) -> float:
        x = _numpy(x)
        return float(0.5 * x @ self.A.mean(0) @ x + self.b.mean(0) @ x)

    def suboptimality(self, params) -> float:
        return self.f(params["x"]) - self.f_star


def make_paper_fig3(G: float = 10.0, mu: float = 0.5, dim: int = 20,
                    seed: int = 0) -> QuadraticDataset:
    """N=2 construction of Theorem VI: f1 = μ|x|² + G·u·x, f2 = −G·u·x
    (A1 = 2μI, A2 = 0; β = 2μ; gradient dissimilarity at x*: G)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=dim)
    u /= np.linalg.norm(u)
    A1 = 2 * mu * np.eye(dim)
    A2 = np.zeros((dim, dim))
    b1 = G * u
    b2 = -G * u
    return QuadraticDataset(np.stack([A1, A2]), np.stack([b1, b2]))


def make_similarity_quadratics(num_clients: int, dim: int, *, delta: float,
                               G: float, beta: float = 1.0, mu: float = 0.1,
                               seed: int = 0) -> QuadraticDataset:
    """N clients with controllable Hessian dissimilarity δ and gradient
    dissimilarity G around a shared strongly-convex base (Thm IV regime)."""
    rng = np.random.default_rng(seed)
    base_eigs = np.linspace(mu, beta, dim)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    A = Q @ np.diag(base_eigs) @ Q.T
    A_list, b_list = [], []
    for i in range(num_clients):
        M = rng.normal(size=(dim, dim))
        M = (M + M.T) / 2
        M = M / max(np.linalg.norm(M, 2), 1e-9) * delta
        Ai = A + M
        w = np.linalg.eigvalsh(Ai)
        if w.min() < 0:
            Ai = Ai - w.min() * np.eye(dim)
        bi = rng.normal(size=dim)
        bi = bi / max(np.linalg.norm(bi), 1e-9) * G
        A_list.append(Ai)
        b_list.append(bi)
    b_arr = np.stack(b_list)
    b_arr = b_arr - b_arr.mean(0, keepdims=True)
    return QuadraticDataset(np.stack(A_list), b_arr)
