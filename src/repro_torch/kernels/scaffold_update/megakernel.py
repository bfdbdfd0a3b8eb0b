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

For tensors on the CPU it runs the plain version
(``ref.scaffold_local_loop_ref``, also the CPU fast path of
``run_local_steps``); for CUDA tensors it launches the kernel or raises.
Launches count in ``ops.LAUNCHES["scaffold_local_loop"]`` (B3) and
``ops.LAUNCHES["scaffold_momentum_local_loop"]`` (B4).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.scaffold_update import ref
from repro_torch.kernels.scaffold_update.ops import LAUNCHES

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _lib():
    lib = build.load("local_loop")
    fn = lib.local_loop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] + [ctypes.c_float]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.local_loop_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.local_loop_smem_bytes.restype = ctypes.c_longlong
    return lib


def scaffold_local_loop_cuda(y, corr, eta_table, A, b, *, m=None,
                             beta: float = 0.0):
    """One kernel launch: ``(y_K, m_K | None, losses)`` for 1-D
    ``y``/``corr`` (corr may be None), ``A (K, bsz, d, d)``, ``b (K, bsz,
    d)`` and a ``(K,)`` eta table, all on one CUDA device; B4 with the
    ``(d,)`` fp32 slot ``m`` and ``beta``, B3 without. The K and bsz
    dimensions of A and b may be strided (broadcast views take no copy);
    their inner blocks must be dense."""
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
    lib = _lib()
    smem = lib.local_loop_smem_bytes(d, m is not None)
    if smem > SMEM_LIMIT:
        raise ValueError(f"scaffold_local_loop: d={d} needs {smem} B of "
                         f"shared memory, more than {SMEM_LIMIT}")
    eta = torch.as_tensor(eta_table, dtype=torch.float32,
                          device=y.device).contiguous()
    if eta.shape != (K,):
        raise ValueError(f"scaffold_local_loop: eta table {tuple(eta.shape)}"
                         f" for K={K}")
    y_out = torch.empty_like(y)
    m_out = None if m is None else torch.empty_like(m)
    losses = torch.empty(K, dtype=torch.float32, device=y.device)
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
            losses.data_ptr(), K, bsz, d, stream)
    name = ("scaffold_local_loop" if m is None
            else "scaffold_momentum_local_loop")
    build.check(err, name)
    LAUNCHES[name] += 1
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
