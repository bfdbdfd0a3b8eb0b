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

A launch walks its group in chunks of ``CHUNK`` elements on a flat grid
(``update_plan``, pure, so the CPU tests reach it). The wrappers check a
tree once per signature (keys, shapes, dtypes, contiguity and devices of
every leaf, never its data pointers) and keep the validated groups and
their plans; a later call with that signature reads only the leaves'
data pointers. A call that changes any of these is checked again and
raises as the first would.

Each wrapper takes the ``device`` it runs on (``"cuda"`` by default,
which raises where there is no CUDA device) and refuses tensors that lie
elsewhere. For tensors on the CPU it runs the plain version (``ref.py``);
for CUDA tensors it launches the kernel or raises. ``LAUNCHES`` counts the
kernel launches of this process, by kernel name; a wrapper adds one where
it launches, nowhere else (a group with no element launches nothing).
A launch captured in a CUDA graph counts once at each replay
(``kernels.counts``). The launch reads the tree's pointers, ``eta`` and
``beta`` by value, so a captured launch keeps them: the trainer captures
a round over static buffers and a constant ``eta_l``.
"""
from __future__ import annotations

import array
import ctypes
import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import build, counts
from repro_torch.kernels.scaffold_update import ref

LAUNCHES: Dict[str, int] = {
    "scaffold_update": 0, "scaffold_momentum_update": 0,
    "scaffold_local_loop": 0, "scaffold_momentum_local_loop": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CAPACITIES = (4, 256)  # leaf tables of one launch (LeafTable<Cap>)
MAX_LEAVES = CAPACITIES[-1]
CHUNK = 2048  # elements a chunk (kChunk; the library is checked against it)
ROLES = ("y", "g", "corr", "out", "m", "m_out")
CACHE_SIZE = 64  # tree signatures whose validated groups are kept


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """One launch's layout over a dtype group: a leaf table of
    ``capacity`` entries; leaf i owns chunks ``first[i]`` to ``first[i +
    1] - 1``, chunk j of a leaf its elements ``[j*CHUNK, min(n, (j +
    1)*CHUNK))``; block b of ``grid`` takes chunks b, b + grid, ... A
    group with no element has grid 0 and is not launched."""
    capacity: int
    first: Tuple[int, ...]
    grid: int


def table_capacity(n_leaves: int) -> int:
    """The smallest leaf table that takes a group of ``n_leaves``; raises
    ValueError past ``MAX_LEAVES``."""
    if not 1 <= n_leaves <= MAX_LEAVES:
        raise ValueError(f"scaffold_update: a dtype group of {n_leaves} "
                         f"leaves; the kernel's table takes 1 to "
                         f"{MAX_LEAVES}")
    return next(c for c in CAPACITIES if c >= n_leaves)


def update_plan(sizes: Sequence[int], wave: int) -> UpdatePlan:
    """The plan of a group of leaves of ``sizes`` elements on a card that
    holds ``wave`` blocks at once (SMs x blocks an SM): the smallest table
    that takes the group, the chunk prefix (a zero-element leaf has no
    chunk, a 62-element one one), and a grid of ``min(chunks, wave)``
    blocks, none without work. A leaf's 16-B alignment is read from its
    pointers at each launch and does not change the plan: the chunks of a
    misaligned leaf take the scalar path. Raises ValueError past
    ``MAX_LEAVES`` leaves."""
    capacity = table_capacity(len(sizes))
    if wave < 1 or min(sizes) < 0:
        raise ValueError(f"update_plan: wave {wave}, sizes {list(sizes)}")
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-n // CHUNK))
    return UpdatePlan(capacity, tuple(first), min(first[-1], wave))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("scaffold_update")
    lib.scaffold_update_group.argtypes = ([ctypes.c_void_p] * 2
                                          + [ctypes.c_float] * 2
                                          + [ctypes.c_void_p])
    lib.scaffold_update_group.restype = ctypes.c_int
    lib.scaffold_update_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.scaffold_update_blocks_per_sm.restype = ctypes.c_int
    lib.scaffold_update_floor.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.scaffold_update_floor.restype = ctypes.c_int
    lib.scaffold_update_chunk.restype = ctypes.c_int
    if lib.scaffold_update_chunk() != CHUNK:
        raise RuntimeError(f"scaffold_update: the library's chunk is "
                           f"{lib.scaffold_update_chunk()} elements, the "
                           f"planner's {CHUNK}")
    return lib


@functools.lru_cache(maxsize=None)
def _wave(device: int, codes: Tuple[int, ...], capacity: int) -> int:
    """Blocks the card holds at once of the kernel for dtype ``codes``
    (y, g, corr[, m]) and a table of ``capacity``."""
    with torch.cuda.device(device):
        per_sm = _lib().scaffold_update_blocks_per_sm(
            *codes[:3], int(len(codes) == 4), capacity)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"scaffold_update: occupancy query failed "
                           f"({-per_sm})")
    return per_sm * sms


def _check_leaf(name, k, leaves) -> None:
    y = leaves[0]
    for what, t in zip(ROLES, leaves):
        if t.device != y.device:
            raise ValueError(f"{name}: {what}[{k!r}] on {t.device}, y on "
                             f"{y.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: {what}[{k!r}] dtype {t.dtype} not in "
                            f"{list(DTYPE_CODES)}")
        if t.shape != y.shape:
            raise ValueError(f"{name}: {what}[{k!r}] shape "
                             f"{tuple(t.shape)} != y shape {tuple(y.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what}[{k!r}] is not contiguous")
    if leaves[3].dtype != y.dtype:
        raise TypeError(f"{name}: out dtype {leaves[3].dtype} != y dtype "
                        f"{y.dtype}")
    for what, t in zip(ROLES[4:], leaves[4:]):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what}[{k!r}] dtype {t.dtype}; the "
                            f"heavy-ball slot is fp32")


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


class _Group(NamedTuple):
    keys: Tuple[str, ...]
    plan: Optional[UpdatePlan]  # None on the CPU
    args: Optional[array.array]  # the launcher's int64 plan
    device: Optional[int]  # CUDA device index
    take: Tuple[int, ...]  # the leaves of each role, in ``_groups``' list


def _validate(name, roles, dev, pos) -> Tuple[_Group, ...]:
    """Check a tree once (structure, devices, dtypes, shapes, contiguity)
    and plan a launch per dtype group on the card. ``pos[r]`` is the
    position of role r's dict among the distinct dicts of ``roles``."""
    y = roles[0]
    for what, t in zip(ROLES[1:], roles[1:]):
        if t.keys() != y.keys():
            raise ValueError(f"{name}: {what} structure differs from y")
    for k in y:
        leaves = [t[k] for t in roles]
        for what, t in zip(ROLES, leaves):
            check_on(f"{name} {what}[{k!r}]", t, dev)
        _check_leaf(name, k, leaves)
    index = {k: i for i, k in enumerate(y)}
    groups = []
    m = roles[4] if len(roles) > 4 else None
    for (device, *dtypes), keys in dtype_groups(*roles[:3], m).items():
        take = tuple(p * len(y) + index[k] for p in pos for k in keys)
        if dev.type == "cpu":
            groups.append(_Group(tuple(keys), None, None, None, take))
            continue
        codes = tuple(DTYPE_CODES[d] for d in dtypes)
        sizes = [y[k].numel() for k in keys]
        plan = update_plan(sizes, _wave(device.index, codes,
                                        table_capacity(len(keys))))
        args = array.array("q", [*codes[:3], int(m is not None), len(keys),
                                 plan.capacity, plan.grid, *sizes,
                                 *plan.first])
        groups.append(_Group(tuple(keys), plan, args, device.index, take))
    return tuple(groups)


_VALIDATED: Dict[tuple, Tuple[_Group, ...]] = {}


def _groups(name, roles, dev):
    """``(groups, leaves)``: the validated groups of a tree, from the
    cache when its signature (keys, which roles share a dict, and each
    leaf's dtype, shape, device and contiguity) was seen, and the leaves
    of its distinct dicts in one list (``out`` passed as the ``y`` dict
    itself is read once)."""
    distinct, pos = [], []
    for t in roles:
        for j, d in enumerate(distinct):
            if d is t:
                pos.append(j)
                break
        else:
            pos.append(len(distinct))
            distinct.append(t)
    keys = tuple(roles[0])
    try:
        leaves = [t[k] for t in distinct for k in keys]
    except KeyError:  # a tree without one of y's keys: _validate raises
        leaves, sig = None, None
    else:
        sig = (name, dev.type, keys, tuple(pos), tuple(map(len, distinct)),
               tuple((t.dtype, t.shape, t.device, t.is_contiguous())
                     for t in leaves))
    groups = _VALIDATED.get(sig)
    if groups is None:
        groups = _validate(name, roles, dev, pos)
        if len(_VALIDATED) >= CACHE_SIZE:
            _VALIDATED.clear()
        _VALIDATED[sig] = groups
    return groups, leaves


def _launch(kernel, grp: _Group, ptrs, eta: float, beta: float) -> None:
    """One launch of B1 (B2) over a validated group; ``ptrs`` the data
    pointers of ``_groups``' leaves."""
    # the pointer array stays referenced here until the call returns
    table = array.array("q", map(ptrs.__getitem__, grp.take))
    fn = _lib().scaffold_update_group
    if grp.device == torch.cuda.current_device():
        err = fn(grp.args.buffer_info()[0], table.buffer_info()[0], eta,
                 beta, torch._C._cuda_getCurrentRawStream(grp.device))
    else:
        with torch.cuda.device(grp.device):
            err = fn(grp.args.buffer_info()[0], table.buffer_info()[0], eta,
                     beta, torch._C._cuda_getCurrentRawStream(grp.device))
    build.check(err, kernel)
    counts.count(LAUNCHES, kernel)


def _packed(name, y, g, corr, out, eta: float, m=None, m_out=None,
            beta: float = 0.0, device="cuda") -> None:
    """The tree-level body of both packed wrappers: ``out`` (and, for the
    heavy-ball step, ``m_out``) receive B1's (B2's) result, computed by
    the plain version on the CPU and by one launch per dtype group on the
    card."""
    dev = resolve_device(device)
    roles = (y, g, corr, out) if m is None else (y, g, corr, out, m, m_out)
    groups, leaves = _groups(name, roles, dev)
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
    kernel = "scaffold_update" if m is None else "scaffold_momentum_update"
    ptrs = [t.data_ptr() for t in leaves]
    eta, beta = float(eta), float(beta)
    for grp in groups:
        if grp.plan.grid:
            _launch(kernel, grp, ptrs, eta, beta)


def plans(y, g, corr, m=None) -> Tuple[UpdatePlan, ...]:
    """The launch plans of a tree of CUDA leaves, one a dtype group, as
    the packed wrappers launch them (out and m_out in place)."""
    roles = (y, g, corr, y) if m is None else (y, g, corr, y, m, m)
    name = ("scaffold_update_packed" if m is None
            else "scaffold_momentum_update_packed")
    groups, _ = _groups(name, roles, resolve_device("cuda"))
    return tuple(grp.plan for grp in groups)


def launch_floor(plan: UpdatePlan, *, momentum: bool = False,
                 device="cuda") -> None:
    """The empty kernel with ``plan``'s leaf table (B2's with
    ``momentum``) on its grid: the floor of one launch. Not a B1/B2
    launch, and not counted."""
    dev = resolve_device(device)
    with torch.cuda.device(dev):
        err = _lib().scaffold_update_floor(
            plan.capacity, int(momentum), plan.grid,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "scaffold_update_floor")


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
