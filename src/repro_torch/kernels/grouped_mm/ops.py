"""The grouped product of the routed experts, the port's
``lax.ragged_dot``.

  grouped_mm             a (M, K) with rows sorted by group, b (G, K, N),
                         ends (G,) int32 on a's device, the groups'
                         cumulative end rows -> (M, N), differentiable in
                         a and b.
  grouped_mm_cuda        one launch of the fp32 kernel's forward.
  grouped_mm_wgrad_cuda  one launch of its weight gradient (G, K, N).

One route a dtype, by this rule:
  * CPU tensors: the plain version (``ref.grouped_mm_ref``, one ``@`` a
    group), chosen because the tensors lie on the CPU;
  * CUDA bf16 (the models at their published widths):
    ``torch._grouped_mm``, the CUTLASS grouped GEMM on the tensor cores,
    which reads the offsets on the device. A library grouped product
    stands in for XLA's ``ragged_dot`` as ``torch.matmul`` stands in for
    jnp's products (the JAX package has no kernel here);
  * CUDA fp32 (the reduced models on the card): the hand-written kernel
    of ``csrc/grouped_mm.cu``, forward and both gradients.
    ``torch._grouped_mm`` in fp32 on CUDA copies the offsets to the host
    (a host sync in every decode step);
  * anything else raises.
``LAUNCHES`` counts the fp32 kernel's launches; the CUDA wrappers add one
where they launch, nowhere else (a launch captured in a CUDA graph once
at each replay, ``kernels.counts``). On a census's fake CUDA tensors
(``launch.census``) the fp32 wrappers make their outputs, launch nothing
and count the launch on the census's tally.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.grouped_mm import ref

LAUNCHES: Dict[str, int] = {"grouped_mm": 0}


def reset_launches() -> None:
    """Set the launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str, n_ll: int):
    fn = getattr(build.load("grouped_mm"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
                       + [ctypes.c_longlong] * n_ll + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def _check(a, b, ends) -> None:
    if a.dim() != 2 or b.dim() != 3 or ends.dim() != 1:
        raise ValueError(f"grouped_mm: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, ends {tuple(ends.shape)}: want "
                         f"a (M, K), b (G, K, N), ends (G,)")
    if b.shape[1] != a.shape[1] or ends.shape[0] != b.shape[0]:
        raise ValueError(f"grouped_mm: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, ends {tuple(ends.shape)}")
    if b.device != a.device or ends.device != a.device:
        raise ValueError(f"grouped_mm: a on {a.device}, b on {b.device}, "
                         f"ends on {ends.device}")
    if b.dtype != a.dtype or ends.dtype != torch.int32:
        raise TypeError(f"grouped_mm: a {a.dtype}, b {b.dtype}, ends "
                        f"{ends.dtype}: want a and b of one dtype, ends "
                        f"int32")


def _cuda_fp32(what: str, *ts) -> None:
    for t in ts:
        if (t.device.type != "cuda" and not counts.fake(t)
                or t.dtype != torch.float32):
            raise ValueError(f"{what}: wants fp32 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")


def _launch(what: str, fn, args, device) -> None:
    if fn is None:  # a census's fake tensors: counted, not launched
        counts.count(LAUNCHES, "grouped_mm")
        return
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    build.check(err, what)
    counts.count(LAUNCHES, "grouped_mm")


def grouped_mm_cuda(a, b, ends):
    """One launch of the fp32 kernel: (M, N), segment g of a times
    ``b[g]``; operands read by strides, the output contiguous."""
    _check(a, b, ends)
    _cuda_fp32("grouped_mm_cuda", a, b)
    m, k = a.shape
    g, _, n = b.shape
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if counts.fake(a):
        _launch("grouped_mm", None, (), a.device)
        return out
    ends = ends.contiguous()
    _launch("grouped_mm", _fn("grouped_mm_fwd", 3),
            (m, k, n, g, a.data_ptr(), *a.stride(), b.data_ptr(),
             *b.stride(), ends.data_ptr(), out.data_ptr()), a.device)
    return out


def grouped_mm_wgrad_cuda(a, d, ends):
    """One launch of the fp32 weight gradient: (G, K, N), ``a[seg g]^T @
    d[seg g]`` for each group g (zeros for an empty one)."""
    _cuda_fp32("grouped_mm_wgrad_cuda", a, d)
    if a.dim() != 2 or d.dim() != 2 or d.shape[0] != a.shape[0]:
        raise ValueError(f"grouped_mm_wgrad_cuda: a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}")
    if ends.device != a.device or ends.dtype != torch.int32:
        raise TypeError(f"grouped_mm_wgrad_cuda: ends {ends.dtype} on "
                        f"{ends.device}")
    m, k = a.shape
    n, g = d.shape[1], ends.shape[0]
    out = torch.empty((g, k, n), dtype=torch.float32, device=a.device)
    if counts.fake(a):
        _launch("grouped_mm_wgrad", None, (), a.device)
        return out
    ends = ends.contiguous()
    _launch("grouped_mm_wgrad", _fn("grouped_mm_wgrad", 2),
            (m, k, n, g, a.data_ptr(), *a.stride(), d.data_ptr(),
             *d.stride(), ends.data_ptr(), out.data_ptr()), a.device)
    return out


class _GroupedMMFP32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, ends):
        ctx.save_for_backward(a, b, ends)
        return grouped_mm_cuda(a, b, ends)

    @staticmethod
    def backward(ctx, grad_out):
        a, b, ends = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = grouped_mm_cuda(grad_out, b.transpose(1, 2), ends)
        if ctx.needs_input_grad[1]:
            db = grouped_mm_wgrad_cuda(a, grad_out, ends)
        return da, db, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the incoming gradient
    contiguous: ``torch._grouped_mm``'s backward refuses a stride-0
    gradient (the one ``.sum()`` gives)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def grouped_mm(a, b, ends):
    """Rows ``[ends[g-1], ends[g])`` of a (M, K) times ``b[g]`` (K, N) for
    each group g -> (M, N) in a's dtype, rows past ``ends[-1]`` zero;
    the route by device and dtype as the module says."""
    _check(a, b, ends)
    card = a.device.type == "cuda" or counts.fake(a)
    if a.device.type == "cpu" and not card:
        return ref.grouped_mm_ref(a, b, ends)
    if not card:
        raise ValueError(f"grouped_mm: tensors on {a.device}")
    if a.dtype == torch.bfloat16:
        return _ContiguousGrad.apply(torch._grouped_mm(a, b, offs=ends))
    if a.dtype == torch.float32:
        return _GroupedMMFP32.apply(a, b, ends)
    raise TypeError(f"grouped_mm: no CUDA route for {a.dtype} (bf16: "
                    f"torch._grouped_mm, fp32: the kernel)")
