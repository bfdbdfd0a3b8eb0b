"""The sliding-window attention op of ``"W"`` layers (B5).

  swa_attention       q (B, S, Hq, D), k and v (B, S, Hkv, D) -> (B, S,
                      Hq, D), differentiable. Forward: the CUDA kernel on
                      CUDA tensors, the plain version (``ref.py``) on CPU
                      tensors, chosen by the tensors' device. Backward:
                      the vector-Jacobian product of the model layer's
                      ``local_attention`` recomputed on the saved q, k
                      and v, as the reference differentiates
                      ``local_attention_jnp`` and rematerialises the layer
                      (the JAX package has no backward kernel).
  swa_attention_cuda  one launch of the kernel on CUDA tensors, no
                      autograd.

The kernel reads the model layout (B, S, H, D) by strides (the head dim
contiguous), so the layer makes no transposed copies. It takes head dims
of 32, 64, 128 and 256, fp32 and bf16. bf16 runs on the tensor cores and
its tiles come in through TMA, which wants 16-byte-aligned base addresses
and strides that are multiples of 16 bytes; fp32 runs the CUDA-core body.
Anything else raises, as does a failed build or launch: on the card
nothing falls back to the plain version or to the other body.
``LAUNCHES`` counts the kernel launches of this process; the CUDA
wrapper adds one where it launches, nowhere else, and a launch captured
in a CUDA graph once at each replay (``kernels.counts``). The bf16
body's TMA descriptors are built on the host from the tensors'
addresses and passed by value: a captured launch reads the same
addresses at every replay, which the graph's memory pool keeps.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.swa_attention import ref

LAUNCHES: Dict[str, int] = {"swa_attention": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations


def reset_launches() -> None:
    """Set the launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    fn = build.load("swa_attention").swa_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window: int) -> None:
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"swa_attention: {what} must be (B, S, H, D), "
                             f"got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"swa_attention: {what} on {t.device} "
                             f"{t.dtype}, q on {q.device} {q.dtype}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape != (b, s, hkv, d) or v.shape != k.shape or hkv == 0
            or hq % hkv):
        raise ValueError(f"swa_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want k and "
                         f"v (B, S, Hkv, D) with Hq a multiple of Hkv")
    if window < 1:
        raise ValueError(f"swa_attention: window {window} < 1")


def _check_tma(what: str, t) -> None:
    """Raise unless TMA can read ``t``: a 16-byte-aligned base and
    (batch, sequence, head) strides that are multiples of 16 bytes."""
    align = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % align for st in t.stride()[:3]):
        raise ValueError(f"swa_attention_cuda: {what} at 0x{t.data_ptr():x}"
                         f" with strides {t.stride()}: the bf16 kernel's TMA"
                         f" copies want a 16-byte-aligned base and strides "
                         f"that are multiples of 16 bytes")


def swa_attention_cuda(q, k, v, window: int):
    """One launch of the sliding-window kernel on CUDA tensors in layout
    (B, S, H, D); returns a fresh contiguous (B, S, Hq, D) output."""
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention_cuda: tensors on {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"swa_attention_cuda: dtype {q.dtype} not in "
                        f"{list(DTYPE_CODES)}")
    b, s, hq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"swa_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"swa_attention_cuda: {what}'s head dim is "
                             f"not contiguous (strides {t.stride()})")
        if q.dtype == torch.bfloat16:
            _check_tma(what, t)
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[st for t in (q, k, v, o)
                                         for st in t.stride()[:3]])
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(DTYPE_CODES[q.dtype], b, s, hq, k.shape[2], d, int(window),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 ctypes.addressof(strides), 1.0 / math.sqrt(d), stream)
    build.check(err, "swa_attention")
    counts.count(LAUNCHES, "swa_attention")
    return o


def _plain(q, k, v, window: int):
    """The plain version in the op's layout (B, S, H, D)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return ref.swa_attention_ref(qt, kt, vt, window).transpose(1, 2)


class _SlidingWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        if q.device.type == "cpu":
            return _plain(q, k, v, window)
        if q.device.type == "cuda":
            return swa_attention_cuda(q, k, v, window)
        raise ValueError(f"swa_attention: tensors on {q.device}")

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.models.layers import local_attention

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = local_attention(*leaves, window=ctx.window)
            grads = torch.autograd.grad(out, leaves, grad_out)
        return (*grads, None)


def swa_attention(q, k, v, window: int):
    """Sliding-window causal attention: ``softmax(mask(q k^T / sqrt(D)))
    v`` over the band ``0 <= q_pos - k_pos < window``, query head h
    reading kv head ``h // (Hq / Hkv)``. q (B, S, Hq, D); k, v (B, S,
    Hkv, D) -> (B, S, Hq, D) in q's dtype."""
    _check(q, k, v, window)
    return _SlidingWindowAttention.apply(q, k, v, window)
