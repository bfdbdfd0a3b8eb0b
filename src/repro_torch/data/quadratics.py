"""Simulated quadratic clients (paper §7.2), a port of the JAX package's
``data/quadratics.py``.

Clients minimise f_i(x) = 1/2 x^T A_i x + b_i^T x. Everything is built
with numpy from the seed, so the same seed gives the same ``A`` and ``b``
as the JAX package. Batches carry the owning client's (A_i, b_i); σ=0
(full batch) as in §7.2.

The scanned engine's device protocol (``device_data``,
``device_batch_fn``, ``device_client_sizes``) keeps every client's
``(A_i, b_i)`` on the device; a round's batch is a gather of the
cohort's rows broadcast over (K, b), as the host path builds it. The
data key is unused: σ=0 clients draw nothing.
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

    def device_data(self, device="cuda") -> Dict:
        """``{"A": (N, d, d), "b": (N, d)}`` fp32 on ``device``."""
        dev = resolve_device(device)
        return {"A": torch.from_numpy(self.A).to(dev),
                "b": torch.from_numpy(self.b).to(dev)}

    def device_batch_fn(self, K: int, b: int):
        """``batch_fn(data, ids, key)``: the cohort's rows of ``data``
        broadcast to ``{"A": (S, K, b, d, d), "b": (S, K, b, d)}``."""
        d = self.dim

        def batch_fn(data, ids, key):
            del key  # full-batch clients: no stochastic data draw
            s = ids.shape[0]
            return {
                "A": data["A"].index_select(0, ids)[:, None, None].expand(
                    s, K, b, d, d),
                "b": data["b"].index_select(0, ids)[:, None, None].expand(
                    s, K, b, d),
            }

        return batch_fn

    def device_client_sizes(self, device="cuda"):
        """``(N,)`` fp32 ones on ``device``."""
        return torch.ones(self.num_clients, dtype=torch.float32,
                          device=resolve_device(device))

    def f(self, x) -> float:
        x = _numpy(x)
        return float(0.5 * x @ self.A.mean(0) @ x + self.b.mean(0) @ x)

    def suboptimality(self, params) -> float:
        return self.f(params["x"]) - self.f_star


class ProceduralQuadraticDataset:
    """Quadratic clients at population scale, with memory O(1) in N.

    ``QuadraticDataset`` keeps every client's ``(d, d)`` curvature; at N =
    10^6 that alone would defeat the tiered store. Here each client's
    objective is computed from its integer id:

        f_i(x) = 1/2 a_i ||x||^2 + b_i^T x,
        a_i in [curvature_lo, curvature_hi),  ||b_i|| <= G,

    by the reference's integer hash (Knuth's multiplicative hash, 24-bit
    fractions, exact in fp32), so the host batches (numpy) and the device
    batches (torch) agree with each other and with the JAX package's bit
    for bit. Batches are laid out as ``QuadraticDataset``'s (A the
    client's ``(d, d)`` matrix ``a_i I`` broadcast over (K, b), the view
    the K-step kernels take); σ=0, full-batch clients.
    """

    def __init__(self, num_clients: int, dim: int, *,
                 curvature: Tuple[float, float] = (0.3, 1.3),
                 G: float = 4.0, seed: int = 0):
        self.num_clients = int(num_clients)
        self.dim = int(dim)
        self.curvature = (float(curvature[0]), float(curvature[1]))
        self.G = float(G)
        self.seed = int(seed)

    def _salts(self):
        """Coordinate j's salt, j = 0 (the curvature) .. d (b's last)."""
        j = np.arange(self.dim + 1, dtype=np.int64)
        return (j * 40503 + self.seed * 2246822519) % (1 << 32)

    @staticmethod
    def _fractions(h):
        """A 32-bit hash's top 24 bits as a fraction in [0, 1)."""
        return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))

    def _coeffs_np(self, ids: np.ndarray):
        """a: (S,) curvatures; b: (S, d) linear terms, by numpy."""
        h = (ids.astype(np.uint32)[:, None] * np.uint32(2654435761)
             + self._salts().astype(np.uint32)[None, :])
        return self._finish(self._fractions(h), np)

    def _coeffs_torch(self, ids: torch.Tensor, salts: torch.Tensor):
        """The same by torch on ids' device (``salts`` there too): the
        hash in int64, wrapped to 32 bits after the multiply and after the
        add (exact: both operands stay under 2^63), every coordinate in
        one broadcast."""
        h = (ids.long()[:, None] * 2654435761) & 0xFFFFFFFF
        h = (h + salts[None, :]) & 0xFFFFFFFF
        u = (h >> 8).float() * (1.0 / (1 << 24))
        return self._finish(u, torch)

    def _finish(self, u, xp):
        """(S, d + 1) fractions -> a and b, in fp32 (one rounding an
        operation, as the reference's)."""
        lo, hi = self.curvature
        # fp32 constants: numpy scalars for numpy, their exact values as
        # Python floats for torch (a tensor's dtype wins over a float)
        f32 = np.float32 if xp is np else (lambda v: float(np.float32(v)))
        a = f32(lo) + f32(hi - lo) * u[:, 0]
        b = u[:, 1:] * f32(2.0) - f32(1.0)
        return a, b * f32(self.G / np.sqrt(self.dim))

    def _layout(self, a, lin, K: int, b: int):
        """``{"A": (S, K, b, d, d), "b": (S, K, b, d)}``: the per-client
        ``a_i I`` and ``b_i`` broadcast over (K, b)."""
        s, d = lin.shape
        eye = torch.eye(d, dtype=torch.float32, device=lin.device)
        A = a[:, None, None] * eye
        return {"A": A[:, None, None].expand(s, K, b, d, d),
                "b": lin[:, None, None].expand(s, K, b, d)}

    def round_batches(self, ids: np.ndarray, K: int, b: int, rng,
                      device="cuda") -> Dict:
        """The cohort's batches on ``device``, from numpy's arithmetic."""
        del rng  # σ=0 full-batch clients: no stochastic draw
        dev = resolve_device(device)
        a, lin = self._coeffs_np(np.asarray(ids))
        return self._layout(torch.from_numpy(a).to(dev),
                            torch.from_numpy(lin).to(dev), K, b)

    def client_sizes(self, ids: np.ndarray) -> np.ndarray:
        return np.ones(len(ids), np.int64)

    # the device protocol: the data is computed from the ids, so
    # device_data holds only the d + 1 hash salts (no host copy inside a
    # captured round) and the batch fn hashes on the device
    def device_data(self, device="cuda") -> Dict:
        return {"salts": torch.from_numpy(self._salts()).to(
            resolve_device(device))}

    def device_batch_fn(self, K: int, b: int):
        def batch_fn(data, ids, key):
            del key  # σ=0 full-batch clients: no stochastic draw
            a, lin = self._coeffs_torch(ids, data["salts"])
            return self._layout(a, lin, K, b)

        return batch_fn

    def device_client_sizes(self, device="cuda"):
        return torch.ones(self.num_clients, dtype=torch.float32,
                          device=resolve_device(device))

    def f(self, x) -> float:
        """The population objective mean_i f_i(x), in blocks of clients
        (O(N) time, O(block) memory)."""
        x = _numpy(x).astype(np.float32)
        tot, n = 0.0, self.num_clients
        for lo in range(0, n, 65536):
            a, b = self._coeffs_np(np.arange(lo, min(lo + 65536, n)))
            tot += float(np.sum(0.5 * a * (x @ x) + b @ x))
        return tot / n

    def suboptimality(self, params) -> float:
        """f(x) - f(x*), the optimum x* = -mean(b) / mean(a) in closed
        form for isotropic quadratics."""
        tot_a, tot_b, n = 0.0, np.zeros(self.dim, np.float64), self.num_clients
        for lo in range(0, n, 65536):
            a, b = self._coeffs_np(np.arange(lo, min(lo + 65536, n)))
            tot_a += float(a.sum())
            tot_b += b.sum(axis=0)
        x_star = -(tot_b / n) / (tot_a / n)
        return self.f(params["x"]) - self.f(x_star)


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
