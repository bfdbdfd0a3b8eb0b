"""Wrappers of the fused corrected-step kernel (``csrc/scaffold_update.cu``).

  scaffold_update         one leaf.
  scaffold_update_packed  a whole parameter tree: leaves are grouped by
                          their exact ``(y, g, corr)`` dtype triple, never
                          cast, and each group is ONE kernel launch per
                          call (the JAX package's
                          ``ops.scaffold_update_packed`` contract). The
                          launch takes a table of leaf pointers, so no
                          packed copy of the tree is made.

Each wrapper takes the ``device`` it runs on (``"cuda"`` by default,
which raises where there is no CUDA device) and refuses tensors that lie
elsewhere. For tensors on the CPU it runs the plain version (``ref.py``);
for CUDA tensors it launches the kernel or raises. ``LAUNCHES`` counts the
kernel launches of this process, by kernel name; a wrapper adds one where
it launches, nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.scaffold_update import ref

LAUNCHES: Dict[str, int] = {"scaffold_update": 0, "scaffold_local_loop": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 64  # leaf table size of one launch (scaffold_update.cu)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = build.load("scaffold_update")
    fn = lib.scaffold_update_group
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_leaf(name, y, g, corr, out):
    for what, t in (("y", y), ("g", g), ("corr", corr), ("out", out)):
        if t.device != y.device:
            raise ValueError(f"{name}: {what} on {t.device}, y on {y.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: {what} dtype {t.dtype} not in "
                            f"{list(DTYPE_CODES)}")
        if t.shape != y.shape:
            raise ValueError(f"{name}: {what} shape {tuple(t.shape)} != "
                             f"y shape {tuple(y.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} is not contiguous")
    if out.dtype != y.dtype:
        raise TypeError(f"{name}: out dtype {out.dtype} != y dtype {y.dtype}")


def _launch_group(ys, gs, cs, outs, eta: float) -> None:
    """One kernel launch over a dtype group of CUDA leaves."""
    n = len(ys)
    if n > MAX_LEAVES:
        raise ValueError(f"scaffold_update: a dtype group of {n} leaves "
                         f"exceeds the kernel's table of {MAX_LEAVES}")
    ptrs = lambda ts: (ctypes.c_void_p * n)(  # noqa: E731
        *[t.data_ptr() for t in ts])
    py, pg, pc, po = ptrs(ys), ptrs(gs), ptrs(cs), ptrs(outs)
    sizes = (ctypes.c_longlong * n)(*[t.numel() for t in ys])
    fn = _lib()
    with torch.cuda.device(ys[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(DTYPE_CODES[ys[0].dtype], DTYPE_CODES[gs[0].dtype],
                 DTYPE_CODES[cs[0].dtype], n, ctypes.addressof(py),
                 ctypes.addressof(pg), ctypes.addressof(pc),
                 ctypes.addressof(po), ctypes.addressof(sizes), float(eta),
                 stream)
    build.check(err, "scaffold_update")
    LAUNCHES["scaffold_update"] += 1


def dtype_groups(y, g, corr) -> Dict[tuple, list]:
    """Leaf keys grouped by ``(device, y dtype, g dtype, corr dtype)`` in
    first-seen order: one kernel launch per group."""
    groups: Dict[tuple, list] = {}
    for k, yy in y.items():
        key = (yy.device, yy.dtype, g[k].dtype, corr[k].dtype)
        groups.setdefault(key, []).append(k)
    return groups


def scaffold_update(y, g, corr, eta: float, *,
                    out: Optional[torch.Tensor] = None, device="cuda"):
    """``y - eta*(g + corr)`` elementwise, fp32 inside, in y's dtype. Any
    shape. ``out`` (may be ``y`` itself) receives the result."""
    return scaffold_update_packed({"y": y}, {"y": g}, {"y": corr}, eta,
                                  out=None if out is None else {"y": out},
                                  device=device)["y"]


def scaffold_update_packed(y, g, corr, eta: float, *, out=None,
                           device="cuda"):
    """Tree-level fused update: one launch per ``(y, g, corr)`` dtype
    group. ``y``, ``g``, ``corr`` are like-keyed dicts of tensors; every
    leaf of the result equals the per-leaf plain version. ``out`` is an
    optional like-keyed dict of destination leaves (it may be ``y``: the
    caller's working copy is then updated in place, saving a param-sized
    buffer); by default fresh leaves are allocated."""
    dev = resolve_device(device)
    if g.keys() != y.keys() or corr.keys() != y.keys():
        raise ValueError("scaffold_update_packed: tree structures differ")
    if out is None:
        out = {k: torch.empty_like(v) for k, v in y.items()}
    elif out.keys() != y.keys():
        raise ValueError("scaffold_update_packed: out structure differs")
    for k, yy in y.items():
        for what, t in (("y", yy), ("g", g[k]), ("corr", corr[k]),
                        ("out", out[k])):
            check_on(f"scaffold_update {what}[{k!r}]", t, dev)
    if dev.type == "cpu":
        for k, yy in y.items():
            out[k].copy_(ref.scaffold_update_ref(yy, g[k], corr[k], eta))
        return out
    for k, yy in y.items():
        _check_cuda_leaf("scaffold_update", yy, g[k], corr[k], out[k])
    for keys in dtype_groups(y, g, corr).values():
        _launch_group([y[k] for k in keys], [g[k] for k in keys],
                      [corr[k] for k in keys], [out[k] for k in keys], eta)
    return out
