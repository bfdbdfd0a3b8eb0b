"""The dry-run census: what one call of a program of the port costs,
counted without running it (the JAX package's ``launch/hlo_analysis.py``).

PyTorch has no HLO to walk, so the census runs the program itself, on
fake tensors: ``census(fn, *args)`` runs ``fn`` under
``torch._subclasses.fake_tensor.FakeTensorMode`` with a dispatch mode of
its own that sees every aten op. Nothing is allocated and no kernel
runs. A Python loop runs unrolled, so every iteration is counted: the
reference needs its trip-count walker and ``util.set_unroll`` for that.
The census counts

  flops           matmul-like ops (mm, addmm, bmm, baddbmm, mv, dot,
                  _grouped_mm): 2 x |out| x |contraction|, as
                  ``analyze_hlo`` counts dots; elementwise work and the
                  hand-written kernels' own arithmetic are not counted
                  (the reference counts no custom call's either);
  bytes           operand plus output bytes of each aten op that is not
                  a view: an upper bound of the memory traffic, since
                  nothing here is fused (the reference counts a fusion's
                  bytes at its boundary);
  bytes_by_kind   those bytes by op name (``top_kinds``: the largest);
  peak_bytes      the largest sum of live storage bytes on the counted
                  device: a storage is live from the op that makes it
                  until its last tensor is freed (a finalizer on the
                  storage), the arguments from the start (the caching
                  allocator rounds a block up to 512 bytes, which the
                  census does not); arguments wrapped in ``OnHost`` lie
                  in host memory and count in no device byte;
  kernel_launches the launches of the port's hand-written kernels by
                  name: their wrappers meet the fake tensors, check them
                  as on the card, make their outputs and count the
                  launch on the census's tally (``kernels.counts``), so
                  the census follows the card path's kernels, never
                  their plain versions.

``device`` names the device the program is counted on: "cuda" (the
card path, also where no card is present: fake CUDA tensors need none,
and ``device.resolve_device`` admits CUDA inside a census) or "cpu" (the
CPU path, with the kernels' plain versions). Where PyTorch has no CUDA
runtime (a CPU-only build aborts in autograd on fake CUDA tensors) the
card path is counted on fake meta tensors that stand for the card's
(``kernels.counts.census``); ``Census.stand`` says which.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.kernels import counts

aten = torch.ops.aten


def _mm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


# op -> flops from its positional tensor arguments
_FLOPS: Dict[Any, Callable] = {
    aten.mm.default: _mm,
    aten.addmm.default: lambda bias, a, b, *_: _mm(a, b),
    aten.bmm.default: _bmm,
    aten.baddbmm.default: lambda bias, a, b, *_: _bmm(a, b),
    aten.mv.default: lambda a, x, *_: 2.0 * a.shape[0] * a.shape[1],
    aten.dot.default: lambda a, b, *_: 2.0 * a.shape[0],
    aten.vdot.default: lambda a, b, *_: 2.0 * a.shape[0],
    # rows of a (M, K) each times one group's (K, N)
    aten._grouped_mm.default: lambda a, b, *_: 2.0 * a.shape[0]
    * a.shape[1] * b.shape[-1],
}


# ops that return a tensor on their input's storage without being marked
# as views: they move no bytes
_ALIASING = {aten._unsafe_view.default, aten._reshape_alias.default,
             aten.lift_fresh.default}


@dataclasses.dataclass
class Census:
    """What one call of a program costs (the module's docstring)."""

    device: str
    stand: str = ""  # the device type the fake tensors lay on
    flops: float = 0.0
    bytes: float = 0.0
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0

    def top_kinds(self, n: int = 12) -> Dict[str, float]:
        """The ``n`` op kinds of the most bytes."""
        return dict(sorted(self.bytes_by_kind.items(),
                           key=lambda kv: -kv[1])[:n])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OnHost:
    """An argument tree of ``census`` whose tensors lie in host memory
    (the trainer's c_i rows): fake CPU tensors, whatever the device."""

    def __init__(self, tree):
        self.tree = tree


class _CensusMode(TorchDispatchMode):
    """Counts flops and bytes of every aten op, and the live storages of
    the counted device."""

    def __init__(self, result: Census, device_type: str):
        super().__init__()
        self.result = result
        self.device_type = device_type
        self.live: Dict[int, int] = {}
        self.current = 0

    def _release(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        old = self.live.get(key)
        if old is None:
            weakref.finalize(st, self._release, key)
            self.live[key] = n
            self.current += n
        elif n > old:  # a storage resized in place
            self.live[key] = n
            self.current += n - old
        self.result.peak_bytes = max(self.result.peak_bytes, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":  # prim.device and the like
            return out
        r = self.result
        r.ops += 1
        flops = _FLOPS.get(func)
        if flops is not None:
            r.flops += flops(*args)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _ALIASING):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if n:
                r.bytes += n
                name = func.overloadpacket.__name__
                r.bytes_by_kind[name] = r.bytes_by_kind.get(name, 0) + n
        for t in outs:
            self.track(t)
        return out


def _storage_bytes(tree, device_type: str) -> int:
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == device_type:
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def census(fn, *args, device="cuda", **kwargs) -> Census:
    """Run ``fn(*args, **kwargs)`` on fake tensors and count it (the
    module's docstring). Every tensor of ``args`` and ``kwargs`` (meta,
    fake or real: ``models.model.input_specs``' stand-ins, a
    ``param_tree`` on the meta device) stands for a fake tensor of its
    shape, strides and dtype on ``device`` (on the host inside an
    ``OnHost``), made inside the census: those on ``device`` are the
    argument bytes, live from the start. Returns the ``Census``; the
    outputs' distinct storages on ``device`` are ``output_bytes``."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"census: unsupported device {str(dev)!r}")
    stand = dev.type
    if stand == "cuda" and not torch.cuda.is_available():
        stand = "meta"
    result = Census(device=str(dev), stand=stand)
    mode = _CensusMode(result, stand)
    where = torch.device(stand) if stand == "meta" else dev

    def fake(t, where=where):
        if isinstance(t, OnHost):
            return tree_map(lambda u: fake(u, torch.device("cpu")), t.tree)
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                   dtype=t.dtype, device=where)

    with counts.census(stand) as tally, \
            FakeTensorMode(allow_non_fake_inputs=True), mode:
        fargs, fkwargs = tree_map(fake, (args, kwargs),
                                  is_leaf=lambda t: isinstance(t, OnHost))
        result.argument_bytes = mode.current
        out = fn(*fargs, **fkwargs)
        result.output_bytes = _storage_bytes(out, stand)
        del out, fargs, fkwargs
    result.kernel_launches = {str(k): n for k, n in tally.launches().items()}
    return result
