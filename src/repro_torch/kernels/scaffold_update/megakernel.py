"""Wrapper of the K-step local-loop kernels (``csrc/local_loop.cu``).

``scaffold_local_loop`` runs all K corrected steps of one client on the
quadratics substrate in one launch: the gradient
``sym(mean_b A_k) y + mean_b b_k`` is computed inside the kernel, the
``c - c_i`` correction and the step follow, and the per-step losses come
back as a ``(K,)`` fp32 tensor. The sgd step (also ``sgd_sched``'s, by
its eta table) is kernel B3; with an fp32 slot ``m`` the heavy-ball step
``m <- beta*m + g; y <- y - eta_k*m`` is kernel B4, which returns
``m_K``. The JAX package's ``kernels/scaffold_update/megakernel.py`` is
the reference.

A launch is a cooperative grid over the card: ``local_loop_plan`` (pure,
so the CPU tests reach it) gives each of G blocks R consecutive entries
of y, says whether the slabs of A it needs stay resident in shared
memory or stream, and sizes the shared memory against ``SMEM_LIMIT``.

For tensors on the CPU it runs the plain version
(``ref.scaffold_local_loop_ref``, also the CPU fast path of
``run_local_steps``); for CUDA tensors it launches the kernel or raises.
Launches count in ``ops.LAUNCHES["scaffold_local_loop"]`` (B3) and
``ops.LAUNCHES["scaffold_momentum_local_loop"]`` (B4); ``PLANS`` counts
the plans they launched with; a launch captured in a CUDA graph counts
at each replay (``kernels.counts``). The cooperative launch goes through
``cudaLaunchKernelEx`` with the cooperative attribute, which a stream
capture records as a graph node. On a census's fake CUDA tensors
(``launch.census``) the wrapper checks them, launches nothing and counts
the launch on the census's tally (no plan: a plan needs the card).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import build, counts
from repro_torch.kernels.scaffold_update import ref
from repro_torch.kernels.scaffold_update.ops import LAUNCHES

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
CHUNK_PAD = 4  # floats after each slab row in shared memory (kPad)
MIN_CHUNK = 32  # narrowest streamed chunk: one column a lane of a warp
NOT_CO_RESIDENT = -1  # the C entries' return for a grid that cannot fit


@dataclasses.dataclass(frozen=True)
class LoopPlan:
    """One launch's layout: ``grid`` blocks, block b owning entries
    ``[b*rows, min(d, (b+1)*rows))`` of y; slabs of ``chunk`` columns,
    ``resident`` (loaded once) or streamed each step; ``smem_bytes`` of
    dynamic shared memory a block."""
    d: int
    grid: int
    rows: int
    chunk: int
    resident: bool
    smem_bytes: int


# kernel name -> {plan: launches} since the last ``reset_plans``
PLANS: Dict[str, collections.Counter] = {
    "scaffold_local_loop": collections.Counter(),
    "scaffold_momentum_local_loop": collections.Counter()}


def reset_plans() -> None:
    """Forget the plans launched so far."""
    for c in PLANS.values():
        c.clear()


def grid_shape(d: int, sm_count: int) -> Tuple[int, int]:
    """``(G, R)``: at most one block an SM and every block owning at
    least one entry; R = ceil(d / min(sm_count, d)) consecutive entries a
    block, the last block the rest."""
    if d < 1 or sm_count < 1:
        raise ValueError(f"grid_shape: d={d}, sm_count={sm_count}")
    rows = -(-d // min(sm_count, d))
    return -(-d // rows), rows


def smem_bytes(rows: int, chunk: int) -> int:
    """Dynamic shared memory of a block (``smem_floats`` in C, which
    refuses a launch whose bytes differ): two slabs of ``rows`` x ``chunk + CHUNK_PAD`` floats, the y chunk,
    and 6 ``rows`` floats (the row sums, y_I, corr_I, m_I, bm_I)."""
    return 4 * (2 * rows * (chunk + CHUNK_PAD) + chunk + 6 * rows)


def local_loop_plan(d: int, K: int, a_sk: int, sm_count: int) -> LoopPlan:
    """The launch plan for width ``d`` and ``K`` steps whose A has K
    stride ``a_sk`` (elements), on a card of ``sm_count`` SMs. Resident
    when A is one matrix for all steps (``a_sk == 0`` or K 1) and both
    slabs fit; otherwise the widest chunk (a multiple of ``MIN_CHUNK``)
    that fits. Raises ValueError when not even a ``MIN_CHUNK`` chunk
    fits."""
    grid, rows = grid_shape(d, sm_count)
    if (a_sk == 0 or K == 1) and smem_bytes(rows, d) <= SMEM_LIMIT:
        return LoopPlan(d, grid, rows, d, True, smem_bytes(rows, d))
    widest = (SMEM_LIMIT // 4 - 6 * rows - 2 * rows * CHUNK_PAD) // (
        2 * rows + 1)
    widest -= widest % MIN_CHUNK
    if widest < MIN_CHUNK:
        raise ValueError(
            f"scaffold_local_loop: d={d} gives {rows} entries a block on "
            f"{sm_count} SMs; a {MIN_CHUNK}-column chunk of its slabs needs "
            f"{smem_bytes(rows, MIN_CHUNK)} B of shared memory, more than "
            f"{SMEM_LIMIT}")
    chunk = min(widest, d)
    return LoopPlan(d, grid, rows, chunk, False, smem_bytes(rows, chunk))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    lib = build.load("local_loop")
    fn = lib.local_loop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_float]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.local_loop_barrier_floor.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.local_loop_barrier_floor.restype = ctypes.c_int
    return lib


def _check_launch(err: int, what: str, plan: LoopPlan) -> None:
    if err == NOT_CO_RESIDENT:
        raise RuntimeError(f"{what}: a cooperative grid of {plan.grid} "
                           f"blocks with {plan.smem_bytes} B of shared "
                           f"memory each cannot be co-resident on this card")
    build.check(err, what)


def barrier_floor(plan: LoopPlan, K: int, device) -> None:
    """Launch K grid barriers, and nothing else, on ``plan``'s grid and
    shared memory: the floor of the loop's design (not a B3/B4 launch)."""
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.local_loop_barrier_floor(
            plan.grid, K, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "local_loop_barrier_floor", plan)


def scaffold_local_loop_cuda(y, corr, eta_table, A, b, *, m=None,
                             beta: float = 0.0):
    """One kernel launch: ``(y_K, m_K | None, losses)`` for 1-D
    ``y``/``corr`` (corr may be None), ``A (K, bsz, d, d)``, ``b (K, bsz,
    d)`` and a ``(K,)`` eta table, all on one CUDA device; B4 with the
    ``(d,)`` fp32 slot ``m`` and ``beta``, B3 without. The K and bsz
    dimensions of A and b may be strided (broadcast views take no copy);
    their inner blocks must be dense. Raises ValueError for a width no
    plan fits (``local_loop_plan``) and RuntimeError when the card
    refuses the cooperative grid; nothing falls back."""
    K, bsz, d = A.shape[0], A.shape[1], A.shape[2]
    if y.dim() != 1 or y.shape[0] != d:
        raise ValueError(f"scaffold_local_loop: y shape {tuple(y.shape)}, "
                         f"A shape {tuple(A.shape)}")
    if A.shape != (K, bsz, d, d) or b.shape != (K, bsz, d):
        raise ValueError(f"scaffold_local_loop: A {tuple(A.shape)} / b "
                         f"{tuple(b.shape)} are not (K, bsz, d, d) / "
                         f"(K, bsz, d)")
    if A.stride(3) != 1 or A.stride(2) != d or b.stride(2) != 1:
        raise ValueError("scaffold_local_loop: the (d, d) blocks of A and "
                         "the (d,) rows of b must be dense")
    tensors = [("y", y), ("A", A), ("b", b)]
    if corr is not None:
        tensors.append(("corr", corr))
        if corr.shape != y.shape or not corr.is_contiguous():
            raise ValueError("scaffold_local_loop: corr must be a dense "
                             "vector shaped like y")
    for what, t in tensors:
        if t.device != y.device:
            raise ValueError(f"scaffold_local_loop: {what} on {t.device}, "
                             f"y on {y.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"scaffold_local_loop: {what} dtype {t.dtype} "
                            f"not in {list(DTYPE_CODES)}")
    if not y.is_contiguous():
        raise ValueError("scaffold_local_loop: y is not contiguous")
    if m is not None and (m.shape != y.shape or m.dtype != torch.float32
                          or m.device != y.device or not m.is_contiguous()):
        raise ValueError("scaffold_local_loop: the slot m must be a dense "
                         "fp32 vector shaped like y, on y's device")
    eta = torch.as_tensor(eta_table, dtype=torch.float32,
                          device=y.device).contiguous()
    if eta.shape != (K,):
        raise ValueError(f"scaffold_local_loop: eta table {tuple(eta.shape)}"
                         f" for K={K}")
    name = ("scaffold_local_loop" if m is None
            else "scaffold_momentum_local_loop")
    y_out = torch.empty_like(y)
    m_out = None if m is None else torch.empty_like(m)
    losses = torch.empty(K, dtype=torch.float32, device=y.device)
    if counts.fake(y):  # a census: counted, not launched (no card: no plan)
        counts.count(LAUNCHES, name)
        return y_out, m_out, losses
    plan = local_loop_plan(d, K, A.stride(0), _sm_count(y.device))
    lib = _lib()
    # scratch: ybuf (2, d), then partials (K, grid)
    scratch = torch.empty(2 * d + K * plan.grid, dtype=torch.float32,
                          device=y.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.local_loop(
            DTYPE_CODES[y.dtype],
            DTYPE_CODES[corr.dtype] if corr is not None else 0,
            DTYPE_CODES[A.dtype], DTYPE_CODES[b.dtype],
            y.data_ptr(), ptr(corr), ptr(m),
            A.data_ptr(), A.stride(0), A.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            eta.data_ptr(), float(beta), y_out.data_ptr(), ptr(m_out),
            losses.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 2 * d * 4, K, bsz,
            d, plan.grid, plan.rows, plan.chunk, plan.resident,
            plan.smem_bytes, stream)
    _check_launch(err, name, plan)
    counts.count(LAUNCHES, name)
    counts.count(PLANS[name], plan)
    return y_out, m_out, losses


def scaffold_local_loop(y, correction, batches, eta_table, *, m=None,
                        beta: float = 0.0, device="cuda"):
    """Tree-level entry: the whole K-step local loop of one client.

    ``y`` is a params dict with a single 1-D leaf (callers gate on
    ``megakernel_incompatibility`` first); ``correction`` is a like-keyed
    dict or None; ``batches`` is ``{"A": (K, bsz, d, d), "b": (K, bsz,
    d)}``; ``eta_table`` is the ``(K,)`` per-step learning rate. Pass
    ``m`` (a like-keyed fp32 dict) and ``beta`` for the heavy-ball
    variant (B4). Returns ``(y_K, m_K | None, losses (K,))``.
    """
    dev = resolve_device(device)
    ((key, x),) = y.items()
    corr = None if correction is None else correction[key]
    m_leaf = None if m is None else m[key]
    A, bvec = batches["A"], batches["b"]
    for what, t in (("y", x), ("corr", corr), ("m", m_leaf), ("A", A),
                    ("b", bvec)):
        if t is not None:
            check_on(f"scaffold_local_loop {what}", t, dev)
    if dev.type == "cpu":
        y_out, m_out, losses = ref.scaffold_local_loop_ref(
            x, corr, eta_table, A, bvec, m=m_leaf, beta=beta)
    else:
        y_out, m_out, losses = scaffold_local_loop_cuda(
            x, corr, eta_table, A, bvec, m=m_leaf, beta=beta)
    return ({key: y_out}, None if m_out is None else {key: m_out}, losses)
