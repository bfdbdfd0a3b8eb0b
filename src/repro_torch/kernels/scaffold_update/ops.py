"""Wrappers of the fused local-step kernels (``csrc/scaffold_update.cu``).

  scaffold_update                  one leaf of the corrected step (B1).
  scaffold_update_packed           a whole parameter tree: leaves are
                                   grouped by their exact ``(y, g, corr)``
                                   dtype triple, never cast, and each
                                   group is ONE kernel launch per call
                                   (the JAX package's
                                   ``ops.scaffold_update_packed``
                                   contract). The launch takes a table of
                                   leaf pointers, so no packed copy of the
                                   tree is made.
  scaffold_momentum_update         one leaf of the heavy-ball step (B2):
                                   ``m' = beta*m + (g + corr)``,
                                   ``y' = y - eta*m'``.
  scaffold_momentum_update_packed  the same over a tree, one launch per
                                   ``(y, g, corr, m)`` dtype group, ``y'``
                                   and ``m'`` written in place when the
                                   caller asks (the momentum solver does).

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

LAUNCHES: Dict[str, int] = {
    "scaffold_update": 0, "scaffold_momentum_update": 0,
    "scaffold_local_loop": 0, "scaffold_momentum_local_loop": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 256  # leaf table size of one launch (scaffold_update.cu)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = build.load("scaffold_update")
    fn = lib.scaffold_update_group
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_leaf(name, y, g, corr, out, m=None, m_out=None):
    for what, t in (("y", y), ("g", g), ("corr", corr), ("out", out),
                    ("m", m), ("m_out", m_out)):
        if t is None:
            continue
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
    for what, t in (("m", m), ("m_out", m_out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} dtype {t.dtype}; the heavy-ball "
                            f"slot is fp32")


def _launch_group(ys, gs, cs, outs, eta: float, ms=None, m_outs=None,
                  beta: float = 0.0) -> None:
    """One kernel launch over a dtype group of CUDA leaves: B1, or B2 when
    the slot leaves ``ms``/``m_outs`` are given."""
    name = "scaffold_update" if ms is None else "scaffold_momentum_update"
    n = len(ys)
    if n > MAX_LEAVES:
        raise ValueError(f"{name}: a dtype group of {n} leaves exceeds the "
                         f"kernel's table of {MAX_LEAVES}")
    # the pointer tables stay referenced here until the call returns
    table = lambda ts: (ctypes.c_void_p * n)(  # noqa: E731
        *[t.data_ptr() for t in ts])
    tables = [table(ts) for ts in (ys, gs, cs, outs)]
    if ms is not None:
        tables += [table(ms), table(m_outs)]
    py, pg, pc, po, *slots = (ctypes.addressof(t) for t in tables)
    pm, pmo = slots or (None, None)
    sizes = (ctypes.c_longlong * n)(*[t.numel() for t in ys])
    fn = _lib()
    with torch.cuda.device(ys[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(DTYPE_CODES[ys[0].dtype], DTYPE_CODES[gs[0].dtype],
                 DTYPE_CODES[cs[0].dtype], n, py, pg, pc, pm, po, pmo,
                 ctypes.addressof(sizes), float(eta), float(beta), stream)
    build.check(err, name)
    LAUNCHES[name] += 1


def dtype_groups(y, g, corr, m=None) -> Dict[tuple, list]:
    """Leaf keys grouped by ``(device, y dtype, g dtype, corr dtype[, m
    dtype])`` in first-seen order: one kernel launch per group."""
    groups: Dict[tuple, list] = {}
    for k, yy in y.items():
        key = (yy.device, yy.dtype, g[k].dtype, corr[k].dtype)
        if m is not None:
            key += (m[k].dtype,)
        groups.setdefault(key, []).append(k)
    return groups


def _packed(name, y, g, corr, out, eta: float, m=None, m_out=None,
            beta: float = 0.0, device="cuda") -> None:
    """The tree-level body of both packed wrappers: ``out`` (and, for the
    heavy-ball step, ``m_out``) receive B1's (B2's) result, computed by
    the plain version on the CPU and by one launch per dtype group on the
    card."""
    dev = resolve_device(device)
    trees = {"g": g, "corr": corr, "out": out}
    if m is not None:
        trees.update(m=m, m_out=m_out)
    for what, t in trees.items():
        if t.keys() != y.keys():
            raise ValueError(f"{name}: {what} structure differs from y")
    for k, yy in y.items():
        check_on(f"{name} y[{k!r}]", yy, dev)
        for what, t in trees.items():
            check_on(f"{name} {what}[{k!r}]", t[k], dev)
    if dev.type == "cpu":
        for k, yy in y.items():
            if m is None:
                out[k].copy_(ref.scaffold_update_ref(yy, g[k], corr[k], eta))
            else:
                y_new, m_new = ref.scaffold_momentum_update_ref(
                    yy, g[k], corr[k], m[k], eta, beta)
                out[k].copy_(y_new)
                m_out[k].copy_(m_new)
        return
    for k, yy in y.items():
        slot = () if m is None else (m[k], m_out[k])
        _check_cuda_leaf(name, yy, g[k], corr[k], out[k], *slot)
    for keys in dtype_groups(y, g, corr, m).values():
        pick = lambda tree: [tree[k] for k in keys]  # noqa: E731
        _launch_group(pick(y), pick(g), pick(corr), pick(out), eta,
                      ms=None if m is None else pick(m),
                      m_outs=None if m is None else pick(m_out), beta=beta)


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
    if out is None:
        out = {k: torch.empty_like(v) for k, v in y.items()}
    _packed("scaffold_update_packed", y, g, corr, out, eta, device=device)
    return out


def scaffold_momentum_update(y, g, corr, m, eta: float, beta: float, *,
                             out: Optional[torch.Tensor] = None,
                             m_out: Optional[torch.Tensor] = None,
                             device="cuda"):
    """``(y', m')`` with ``m' = beta*m + (g + corr)`` and ``y' = y - eta*m'``
    elementwise, fp32 inside; ``y'`` in y's dtype, ``m'`` fp32. Any shape.
    ``out``/``m_out`` (may be ``y``/``m`` themselves) receive the
    results."""
    ys, ms = scaffold_momentum_update_packed(
        {"y": y}, {"y": g}, {"y": corr}, {"y": m}, eta, beta,
        out=None if out is None else {"y": out},
        m_out=None if m_out is None else {"y": m_out}, device=device)
    return ys["y"], ms["y"]


def scaffold_momentum_update_packed(y, g, corr, m, eta: float, beta: float,
                                    *, out=None, m_out=None, device="cuda"):
    """Tree-level fused heavy-ball update: one launch per ``(y, g, corr,
    m)`` dtype group; returns ``(y_tree, m_tree)``. ``m`` is the fp32
    slot. ``out``/``m_out`` are optional like-keyed dicts of destination
    leaves (they may be ``y``/``m``: the momentum solver updates the
    client's working copy and its slot in place); by default fresh leaves
    are allocated. Every leaf equals the per-leaf plain version."""
    if out is None:
        out = {k: torch.empty_like(v) for k, v in y.items()}
    if m_out is None:
        m_out = {k: torch.empty_like(v) for k, v in m.items()}
    _packed("scaffold_momentum_update_packed", y, g, corr, out, eta, m=m,
            m_out=m_out, beta=beta, device=device)
    return out, m_out
