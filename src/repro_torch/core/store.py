"""The population client store (the JAX package's ``core/store.py``).

SCAFFOLD keeps a control variate ``c_i`` for every client, so its state
grows with the population N, not with the cohort S. This module holds
that population:

  ``StoreBackend``       where the ``(N, ...)`` rows live: an
                         allocate / read_rows / write_rows protocol and a
                         registry of factories. Built in: ``dense`` (host
                         tensors), ``memmap`` (``.npy`` files on disk, the
                         host memory a page cache's working set) and
                         ``sharded`` (``repro_torch.dist.store``: rows in
                         contiguous blocks across logical hosts).
  ``ClientStateStore``   one per-client state tree for all N clients
                         behind a backend. Ownership is copy-on-gather.
  ``TieredClientStore``  the gather-ahead tier: one worker thread runs
                         all backend I/O, so the caller can prefetch the
                         next cohort's rows and write the last cohort's
                         back while the card computes. A prefetched row
                         that a later write overwrote is re-read when the
                         prefetch is taken (``refresh_rows``).

A tree is a flat dict of tensors: the control variates keyed as the
model's leaves, a stateful local solver's slots as one flat family
(``core.tree.tree_flatten_slots``: fp32 ``"m/<leaf>"`` and ``"v/<leaf>"``
rows, adam's step counter as an ``(N,)`` int32 row ``"t"``). Rows are
host tensors; a template may live on any device (the meta device too),
the store reads only its shapes and dtypes.

The stale-row invariant: a prefetched gather taken at time t equals a
synchronous gather at time t. The worker runs reads and writes in the
order they were submitted, so a synchronous gather submitted after a
write sees it; a prefetch issued before a write is repaired instead:
each ``scatter_async`` records its ids against every prefetch in flight,
and ``take`` re-reads exactly the rows that intersect. Evicting a
prefetch is always safe: prefetched rows are read-only copies, and an
unwritten row lives only in the write queue and the backend.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _as_ids(ids) -> np.ndarray:
    """Row ids (an array, a list or a tensor on any device) as int64
    numpy."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, dtype=np.int64).reshape(-1)


# ---------------------------------------------------------------------------
# the StoreBackend protocol and its registry
# ---------------------------------------------------------------------------


class StoreBackend:
    """Where the ``(N, ...)`` population rows of one leaf live.

    One instance a store (a backend owns memory or files, so the
    registry maps names to factories). The contract:

      * ``allocate(num_rows, shape, dtype)`` returns an opaque handle of
        zero ``(num_rows,) + shape`` rows of the torch ``dtype``;
      * ``read_rows(handle, ids)`` returns an owned host tensor, never a
        view of the backend's memory (callers repair gathered rows in
        place);
      * ``write_rows(handle, ids, rows)`` copies the host tensor's values
        in; the caller keeps ``rows``.

    ``ids`` are int64 numpy arrays, distinct within a call.
    """

    name: str = ""

    def allocate(self, num_rows: int, shape: Tuple[int, ...],
                 dtype: torch.dtype) -> Any:
        raise NotImplementedError

    def read_rows(self, handle, ids: np.ndarray) -> torch.Tensor:
        raise NotImplementedError

    def write_rows(self, handle, ids: np.ndarray,
                   rows: torch.Tensor) -> None:
        raise NotImplementedError

    def nbytes(self, handle) -> int:
        """Bytes the handle occupies in this backend's tier."""
        return int(handle.nbytes)

    def close(self) -> None:
        """Release backing resources (files, shards). Idempotent."""


class DenseBackend(StoreBackend):
    """Host tensors: the default."""

    name = "dense"

    def allocate(self, num_rows, shape, dtype):
        return torch.zeros((num_rows,) + tuple(shape), dtype=dtype)

    def read_rows(self, handle, ids):
        return handle.index_select(0, torch.from_numpy(ids))

    def write_rows(self, handle, ids, rows):
        handle.index_copy_(0, torch.from_numpy(ids), rows)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a leaf of ``dtype`` is kept as on disk: bf16,
    which numpy lacks, as its raw 2-byte words (int16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty(0, dtype=dtype).numpy().dtype


class _MemmapLeaf:
    """A memmap backend's handle: the file's array and the leaf's torch
    dtype."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.memmap, dtype: torch.dtype):
        self.array, self.dtype = array, dtype

    @property
    def nbytes(self) -> int:
        return int(self.array.nbytes)


class MemmapBackend(StoreBackend):
    """Rows in ``.npy`` files opened as ``np.memmap``: the population's
    host memory is the page cache's working set. The files live in
    ``directory`` (default: a temporary directory removed on ``close``).
    A bf16 leaf is kept as its raw 2-byte words and viewed back."""

    name = "memmap"

    def __init__(self, directory: str = ""):
        self._tmp = None
        if not directory:
            self._tmp = tempfile.TemporaryDirectory(prefix="repro-store-")
            directory = self._tmp.name
        self.directory = directory
        self._leaves: List[_MemmapLeaf] = []

    def allocate(self, num_rows, shape, dtype):
        path = os.path.join(self.directory, f"leaf{len(self._leaves)}.npy")
        # a new file reads as zeros: no pass over its pages
        mm = np.lib.format.open_memmap(
            path, mode="w+", dtype=_numpy_dtype(dtype),
            shape=(num_rows,) + tuple(shape))
        leaf = _MemmapLeaf(mm, dtype)
        self._leaves.append(leaf)
        return leaf

    def read_rows(self, handle, ids):
        # advanced indexing of a memmap makes an owned array in memory
        rows = torch.from_numpy(handle.array[ids])
        return (rows.view(torch.bfloat16) if handle.dtype == torch.bfloat16
                else rows)

    def write_rows(self, handle, ids, rows):
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        handle.array[ids] = rows.contiguous().numpy()

    def close(self):
        self._leaves.clear()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None


_STORE_BACKENDS: Dict[str, Callable[..., StoreBackend]] = {}


def register_store_backend(name: str,
                           factory: Callable[..., StoreBackend]) -> None:
    """Register a backend factory (called once a store)."""
    assert name, "store backends must be registered under a name"
    _STORE_BACKENDS[name] = factory


def _ensure_builtin_backends() -> None:
    # the sharded backend lives in the dist layer; importing it registers
    # it, lazily, as the reference's does
    if "sharded" not in _STORE_BACKENDS:
        from repro_torch.dist import store as _dist_store  # noqa: F401


def make_store_backend(name: str, **kwargs) -> StoreBackend:
    """Build a registered store backend; unknown names fail loudly."""
    _ensure_builtin_backends()
    try:
        factory = _STORE_BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown store backend {name!r}; registered: "
            f"{store_backend_names()}") from None
    return factory(**kwargs)


def store_backend_names() -> Tuple[str, ...]:
    """Sorted names of all registered store backends."""
    _ensure_builtin_backends()
    return tuple(sorted(_STORE_BACKENDS))


register_store_backend("dense", DenseBackend)
register_store_backend("memmap", MemmapBackend)


# ---------------------------------------------------------------------------
# stale-row repair
# ---------------------------------------------------------------------------


def stale_mask(ids, ids_written) -> np.ndarray:
    """Boolean mask over a prefetched gather's ``ids`` marking the rows
    that a later write of ``ids_written`` invalidated."""
    return np.isin(_as_ids(ids), _as_ids(ids_written))


def refresh_rows(prefetched, fresh, stale: np.ndarray) -> None:
    """Overwrite the stale rows of a prefetched gather in place with
    ``fresh`` (the ``stale.sum()`` rows gathered again), which restores
    gather-when-taken semantics; copy-on-gather makes the in-place
    repair safe."""
    where = torch.from_numpy(np.flatnonzero(stale))
    for k, leaf in prefetched.items():
        leaf.index_copy_(0, where.to(leaf.device),
                         fresh[k].to(leaf.device, leaf.dtype))


# ---------------------------------------------------------------------------
# the population store
# ---------------------------------------------------------------------------


class ClientStateStore:
    """One per-client state tree for all N clients (control variates,
    the codec's residuals, the local solver's slots: one instance a row
    family) behind a ``StoreBackend``.

    Ownership is copy-on-gather: ``gather`` returns rows the caller owns
    (writing to them never reaches the population, and a later scatter
    never changes them); ``scatter`` copies values in, from any device.
    """

    def __init__(self, template, num_clients: int,
                 backend: "str | StoreBackend" = "dense"):
        self.num_clients = num_clients
        self.backend = (backend if isinstance(backend, StoreBackend)
                        else make_store_backend(backend or "dense"))
        # (shape, dtype) of one client's row of each leaf
        self.template = {k: (tuple(v.shape), v.dtype)
                         for k, v in template.items()}
        self._handles = {k: self.backend.allocate(num_clients, shape, dtype)
                         for k, (shape, dtype) in self.template.items()}
        self.row_nbytes = sum(
            int(np.prod(shape, dtype=np.int64))
            * torch.empty(0, dtype=dtype).element_size()
            for shape, dtype in self.template.values())

    # -- raw backend I/O (the tiered store runs these on its worker) --------

    def _read(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        return {k: self.backend.read_rows(h, ids)
                for k, h in self._handles.items()}

    def _write(self, ids: np.ndarray, leaves: Dict[str, torch.Tensor],
               ready=None) -> None:
        if ready is not None:
            # the rows are pinned host buffers an asynchronous copy fills
            ready.synchronize()
        for k, h in self._handles.items():
            self.backend.write_rows(h, ids, leaves[k])

    def _host_leaves(self, new) -> Dict[str, torch.Tensor]:
        """``new``'s leaves on the host in the store's dtypes (a leaf that
        already is, itself)."""
        return {k: new[k].detach().to("cpu", dtype)
                for k, (_, dtype) in self.template.items()}

    # -- public API ------------------------------------------------------------

    def gather(self, ids) -> Dict[str, torch.Tensor]:
        """Rows ``ids`` as a dict of owned host ``(len(ids), ...)``
        tensors."""
        return self._read(_as_ids(ids))

    def scatter(self, ids, new) -> None:
        """Write rows ``ids``; the values are copied in, from any
        device."""
        self._write(_as_ids(ids), self._host_leaves(new))

    def all_rows(self) -> Dict[str, torch.Tensor]:
        """Every client's ``(N, ...)`` rows: the ``dense`` backend's own
        tensors, not copied (read them, write through :meth:`scatter`),
        after the pending writes landed; else a gather of all N."""
        if isinstance(self.backend, DenseBackend):
            self.flush()
            return self._handles
        return self.gather(np.arange(self.num_clients))

    @property
    def population_nbytes(self) -> int:
        """Bytes the N-row population occupies in its backend's tier."""
        return sum(self.backend.nbytes(h) for h in self._handles.values())

    def flush(self) -> None:
        """Wait until every pending write has landed (nothing to wait for
        here: the base store is synchronous)."""

    def drop_prefetches(self) -> None:
        """Forget gather-ahead state (none on the base store)."""

    def close(self) -> None:
        self.backend.close()


class _Prefetch:
    """One gather-ahead read in flight: its ids, the worker's future, and
    the ids of every write issued after it (the rows ``take``
    repairs)."""

    __slots__ = ("ids", "future", "written")

    def __init__(self, ids: np.ndarray, future: Future):
        self.ids = ids
        self.future = future
        self.written: List[np.ndarray] = []


class TieredClientStore(ClientStateStore):
    """``ClientStateStore`` with the gather-ahead and write-back tier.

    All backend I/O goes through one worker thread (shared across row
    families through ``executor``, so repairs order consistently), which
    gives two guarantees:

      * a synchronous ``gather``/``scatter`` submitted after a write sees
        it (the worker runs tasks in order), so the synchronous API gives
        the base store's results bit for bit;
      * a ``prefetch`` issued before a write is repaired when taken:
        ``scatter_async`` records its ids against every prefetch in
        flight, and ``take`` re-reads exactly the rows that intersect.

    At most ``prefetch_depth`` prefetches are kept; evicting the oldest
    is safe, since prefetched rows are read-only copies.
    """

    def __init__(self, template, num_clients: int,
                 backend: "str | StoreBackend" = "dense",
                 prefetch_depth: int = 2,
                 executor: Optional[ThreadPoolExecutor] = None):
        super().__init__(template, num_clients, backend)
        assert prefetch_depth >= 1, prefetch_depth
        self.prefetch_depth = int(prefetch_depth)
        self._own_exec = executor is None
        self._exec = executor or ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tiered-store")
        self._lock = threading.Lock()
        self._inflight: "OrderedDict[Any, _Prefetch]" = OrderedDict()
        self._writes: "deque[Future]" = deque()
        self._poisoned: Optional[BaseException] = None

    # -- a failure on the worker poisons the store ---------------------------
    # A failed backend write, or a worker gone, must surface at the next
    # public call: never a hang, never a write dropped quietly. Every task
    # records its failure; once poisoned, the store refuses all I/O with
    # the original error chained.

    def _note_failure(self, fut: Future) -> None:
        if not fut.cancelled():
            exc = fut.exception()
            if exc is not None and self._poisoned is None:
                self._poisoned = exc

    def _check_poisoned(self) -> None:
        if self._poisoned is not None:
            raise RuntimeError(
                "tiered-store I/O worker previously failed — the store is "
                "poisoned and its contents cannot be trusted (original "
                "error chained below)") from self._poisoned

    def _submit(self, fn, *args) -> Future:
        self._check_poisoned()
        try:
            fut = self._exec.submit(fn, *args)
        except RuntimeError as e:
            raise RuntimeError(
                "tiered-store I/O worker is gone (executor shut down); "
                "the store can no longer serve reads or writes") from e
        fut.add_done_callback(self._note_failure)
        return fut

    # -- synchronous API, ordered behind every pending write -----------------

    def gather(self, ids) -> Dict[str, torch.Tensor]:
        return self._submit(self._read, _as_ids(ids)).result()

    def scatter(self, ids, new) -> None:
        self.scatter_async(ids, new).result()

    # -- the asynchronous tier -------------------------------------------------

    def scatter_async(self, ids, new, ready=None) -> Future:
        """Queue a write of rows ``ids`` and return its future. Leaves on
        a device are copied to the host first; host leaves are borrowed
        until the write lands, so callers hand over rows they will not
        change. With ``ready`` (a ``torch.cuda.Event``) the leaves are
        pinned host buffers that an asynchronous copy fills, and the
        worker waits on the event before writing. Marks every prefetch in
        flight, so ``take`` repairs the overlap."""
        ids = _as_ids(ids)
        leaves = new if ready is not None else self._host_leaves(new)
        with self._lock:
            for pf in self._inflight.values():
                pf.written.append(ids)
            fut = self._submit(self._write, ids, leaves, ready)
            self._writes.append(fut)
            # reap finished writes: the queue stays bounded, and a failure
            # surfaces here rather than only at flush
            while self._writes and self._writes[0].done():
                self._writes.popleft().result()
        return fut

    def prefetch(self, token, ids) -> None:
        """Queue a gather-ahead read of rows ``ids`` under ``token``
        (nothing if the token is already in flight). Past
        ``prefetch_depth`` entries the oldest is evicted."""
        ids = _as_ids(ids).copy()
        with self._lock:
            if token in self._inflight:
                return
            while len(self._inflight) >= self.prefetch_depth:
                self._inflight.popitem(last=False)
            self._inflight[token] = _Prefetch(
                ids, self._submit(self._read, ids))

    def take(self, token, ids) -> Dict[str, torch.Tensor]:
        """A prefetched gather, bit for bit what ``gather(ids)`` returns
        now: rows written after the prefetch was issued are read again
        (behind the writes, on the worker). A miss or other ids fall back
        to a synchronous gather."""
        self._check_poisoned()
        ids = _as_ids(ids)
        with self._lock:
            pf = self._inflight.pop(token, None)
        if pf is None or not np.array_equal(pf.ids, ids):
            return self.gather(ids)
        rows = pf.future.result()
        # popped above: no scatter_async can append to pf.written now
        if pf.written:
            stale = stale_mask(ids, np.concatenate(pf.written))
            if stale.any():
                refresh_rows(rows, self.gather(ids[stale]), stale)
        return rows

    def pending_prefetches(self) -> Tuple[Any, ...]:
        with self._lock:
            return tuple(self._inflight)

    def drop_prefetches(self) -> None:
        """Forget every prefetch in flight (a checkpoint restore: the
        cohort stream restarts from the restored round)."""
        with self._lock:
            self._inflight.clear()

    def flush(self) -> None:
        """Wait until every queued write has landed in the backend."""
        self._check_poisoned()
        while True:
            with self._lock:
                if not self._writes:
                    return
                fut = self._writes.popleft()
            fut.result()

    def close(self) -> None:
        try:
            self.flush()
        except RuntimeError:
            # a poisoned or shut-down store still releases its resources;
            # the failure surfaced (or will) through the public calls
            pass
        self.drop_prefetches()
        if self._own_exec:
            self._exec.shutdown(wait=True)
        super().close()
