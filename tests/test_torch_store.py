"""The port's population store (``repro_torch.core.store``,
``repro_torch.dist.store``) against the reference's, on the same inputs.

For each backend (dense, memmap, sharded):

  * round trip: any interleaving of scatters and gathers (Hypothesis, as
    the reference's property tests draw them) gathers what the
    reference's store gathers;
  * copy-on-gather: a gathered row is the caller's, a scattered one is
    copied in;
  * interleaved write-back ordering: ``take`` after any mix of
    ``prefetch`` and ``scatter_async`` returns what the reference's
    tiered store returns, and what a synchronous gather would;
  * ``row_nbytes`` and ``population_nbytes`` equal the reference's, bf16
    and int32 leaves among them.

Also: eviction never drops an unwritten row; a ``take`` miss or other
ids fall back; ``stale_mask`` and ``refresh_rows`` against the
reference's; the registry's names; the ragged last shard; a bf16 leaf
kept as raw words on disk; a write that waits on its copy's event; a
failed write poisons the store (never a hang), and only that store; a
stress run of the worker under a short switch interval.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import store as jstore
from repro.dist.store import ShardedBackend as JSharded
from repro_torch.core import store as tstore
from repro_torch.dist.store import ShardedBackend

BACKENDS = ("dense", "memmap", "sharded")
N = 17
TEMPLATE = {"w": torch.zeros(3), "m": torch.zeros(2)}
JTEMPLATE = {"w": np.zeros((3,), np.float32), "m": np.zeros((2,), np.float32)}


def _pair(backend, tiered=False, **kw):
    """The port's store and the reference's, same backend and size."""
    tcls = tstore.TieredClientStore if tiered else tstore.ClientStateStore
    jcls = jstore.TieredClientStore if tiered else jstore.ClientStateStore
    return (tcls(TEMPLATE, N, backend=tstore.make_store_backend(backend),
                 **kw),
            jcls(JTEMPLATE, N, backend=jstore.make_store_backend(backend),
                 **kw))


def _rows(rng, ids):
    """Random rows of both leaves, as numpy (the reference's) and torch
    (the port's) of the same values."""
    rows = {"w": rng.normal(size=(len(ids), 3)).astype(np.float32),
            "m": rng.normal(size=(len(ids), 2)).astype(np.float32)}
    return rows, {k: torch.from_numpy(v.copy()) for k, v in rows.items()}


def _assert_same(port_rows, ref_rows):
    assert set(port_rows) == set(ref_rows)
    for k, v in ref_rows.items():
        got = port_rows[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)


def _close(*stores):
    for s in stores:
        s.close()


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_roundtrip_matches_the_reference(backend, seed):
    rng = np.random.default_rng(seed)
    port, ref = _pair(backend)
    try:
        for _ in range(8):
            ids = rng.choice(N, size=rng.integers(1, N + 1), replace=False)
            if rng.random() < 0.7:
                jrows, trows = _rows(rng, ids)
                ref.scatter(ids, jrows)
                port.scatter(torch.from_numpy(ids), trows)
            _assert_same(port.gather(ids), ref.gather(ids))
        _assert_same(port.gather(np.arange(N)), ref.gather(np.arange(N)))
    finally:
        _close(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_copy_on_gather(backend):
    rng = np.random.default_rng(0)
    port, _ = _pair(backend)
    try:
        ids = np.array([1, 5, 9])
        _, rows = _rows(rng, ids)
        port.scatter(ids, rows)
        rows["w"][:] = -1.0  # the caller's rows, not the store's
        got = port.gather(ids)
        assert not (got["w"] == -1.0).any()
        got["w"][:] = -2.0  # a gathered row does not write through
        held = port.gather(ids)
        assert not (held["w"] == -2.0).any()
        before = {k: v.clone() for k, v in held.items()}
        port.scatter(ids, _rows(rng, ids)[1])  # nor a later scatter into it
        for k in held:
            assert torch.equal(before[k], held[k])
    finally:
        port.close()


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_interleaved_writeback_matches_the_reference(backend, seed):
    rng = np.random.default_rng(seed)
    port, ref = _pair(backend, tiered=True, prefetch_depth=3)
    try:
        inflight = {}
        for step in range(24):
            op = rng.random()
            if op < 0.4:  # write-back
                ids = rng.choice(N, size=rng.integers(1, 7), replace=False)
                jrows, trows = _rows(rng, ids)
                ref.scatter_async(ids, jrows)
                port.scatter_async(ids, trows)
            elif op < 0.7:  # gather-ahead
                ids = rng.choice(N, size=rng.integers(1, 7), replace=False)
                ref.prefetch(step, ids)
                port.prefetch(step, ids)
                inflight[step] = ids
            elif inflight:  # take (maybe evicted: a hit and a miss agree)
                token = next(iter(inflight))
                ids = inflight.pop(token)
                _assert_same(port.take(token, ids), ref.take(token, ids))
        port.flush()
        ref.flush()
        _assert_same(port.gather(np.arange(N)), ref.gather(np.arange(N)))
    finally:
        _close(port, ref)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_eviction_never_drops_an_unwritten_row(seed):
    rng = np.random.default_rng(seed)
    port, ref = _pair("dense", tiered=True, prefetch_depth=1)
    try:
        for t in range(20):
            ids = rng.choice(N, size=4, replace=False)
            jrows, trows = _rows(rng, ids)
            port.scatter_async(ids, trows)
            ref.scatter(ids, jrows)
            port.prefetch(("evict-me", t), rng.choice(N, size=4,
                                                      replace=False))
        port.flush()
        _assert_same(port.gather(np.arange(N)), ref.gather(np.arange(N)))
    finally:
        _close(port, ref)


def test_take_miss_and_other_ids_fall_back():
    port, _ = _pair("dense", tiered=True)
    try:
        ids = np.array([2, 4, 6])
        jrows, rows = _rows(np.random.default_rng(1), ids)
        port.scatter(ids, rows)
        _assert_same(port.take("never-issued", ids), jrows)
        port.prefetch("tok", np.array([0, 1]))
        _assert_same(port.take("tok", ids), jrows)
        assert port.pending_prefetches() == ()
    finally:
        port.close()


def test_stale_mask_and_refresh_rows_match_the_reference():
    ids, written = np.array([3, 7, 1, 9]), np.array([7, 9, 50])
    want = jstore.stale_mask(ids, written)
    np.testing.assert_array_equal(tstore.stale_mask(torch.from_numpy(ids),
                                                    written), want)
    assert not tstore.stale_mask(ids, np.array([], np.int64)).any()
    jpre = {"w": np.zeros((4, 3), np.float32)}
    tpre = {"w": torch.zeros(4, 3)}
    fresh = np.arange(6, dtype=np.float32).reshape(2, 3) + 5.0
    jstore.refresh_rows(jpre, {"w": fresh}, want)
    tstore.refresh_rows(tpre, {"w": torch.from_numpy(fresh)}, want)
    _assert_same(tpre, jpre)


def test_registry_names_match_the_reference():
    assert tstore.store_backend_names() == jstore.store_backend_names()
    with pytest.raises(KeyError, match="unknown store backend"):
        tstore.make_store_backend("hbm3")
    with pytest.raises(AssertionError):
        tstore.register_store_backend("", ShardedBackend)


def test_sharded_ragged_last_shard_matches_the_reference():
    port = tstore.ClientStateStore(TEMPLATE, N, backend=ShardedBackend(5))
    ref = jstore.ClientStateStore(JTEMPLATE, N, backend=JSharded(5))
    ids = np.array([0, 3, 4, 15, 16])  # the first and the ragged last shard
    jrows, trows = _rows(np.random.default_rng(2), ids)
    port.scatter(ids, trows)
    ref.scatter(ids, jrows)
    _assert_same(port.gather(np.arange(N)), ref.gather(np.arange(N)))
    assert [len(s) for s in port._handles["w"]["shards"]] == [4, 4, 4, 4, 1]
    assert port.population_nbytes == ref.population_nbytes


@pytest.mark.parametrize("backend", BACKENDS)
def test_row_and_population_nbytes_match_the_reference(backend):
    import jax.numpy as jnp

    template = {"w": torch.zeros(3), "h": torch.zeros(4, dtype=torch.bfloat16),
                "t": torch.zeros((), dtype=torch.int32)}
    jtemplate = {"w": np.zeros(3, np.float32), "h": jnp.zeros(4, jnp.bfloat16),
                 "t": np.zeros((), np.int32)}
    port = tstore.ClientStateStore(template, N, backend=backend)
    ref = jstore.ClientStateStore(jtemplate, N, backend=backend)
    try:
        assert port.row_nbytes == ref.row_nbytes == 3 * 4 + 4 * 2 + 4
        assert port.population_nbytes == ref.population_nbytes
        assert port.population_nbytes == N * port.row_nbytes
    finally:
        _close(port, ref)


def test_memmap_keeps_bf16_as_raw_words(tmp_path):
    backend = tstore.MemmapBackend(str(tmp_path))
    store = tstore.ClientStateStore(
        {"h": torch.zeros(5, dtype=torch.bfloat16)}, N, backend=backend)
    rows = torch.randn(3, 5).to(torch.bfloat16)
    store.scatter([2, 0, 7], {"h": rows})
    got = store.gather([2, 0, 7])["h"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), rows.view(torch.int16))
    on_disk = np.load(tmp_path / "leaf0.npy")
    assert on_disk.dtype == np.int16
    np.testing.assert_array_equal(on_disk[[2, 0, 7]],
                                  rows.view(torch.int16).numpy())
    assert not on_disk[1].any()


class _Ready:
    """Stands in for a CUDA event: the rows are valid once it is set."""

    def __init__(self):
        self.event = threading.Event()

    def synchronize(self):
        assert self.event.wait(5.0)


def test_scatter_async_waits_for_its_rows():
    port, _ = _pair("dense", tiered=True)
    try:
        ids = np.array([1, 3])
        rows = {"w": torch.zeros(2, 3), "m": torch.zeros(2, 2)}
        ready = _Ready()
        fut = port.scatter_async(ids, rows, ready=ready)
        rows["w"].fill_(4.0)  # the "copy" lands, then the event fires
        rows["m"].fill_(5.0)
        ready.event.set()
        fut.result(timeout=5)
        got = port.gather(ids)
        assert (got["w"] == 4.0).all() and (got["m"] == 5.0).all()
    finally:
        port.close()


class _FailingBackend(tstore.DenseBackend):
    """A dense backend whose writes can be made to fail."""

    def __init__(self):
        self.fail_writes = False

    def write_rows(self, handle, ids, rows):
        if self.fail_writes:
            raise OSError("disk on fire")
        super().write_rows(handle, ids, rows)


def _failing():
    backend = _FailingBackend()
    return tstore.TieredClientStore(TEMPLATE, N, backend=backend), backend


def _await_poison(store):
    for _ in range(500):
        if store._poisoned is not None:
            return
        time.sleep(0.002)
    raise AssertionError("the store never noted the worker's failure")


def test_a_failed_write_poisons_the_store():
    store, backend = _failing()
    rng = np.random.default_rng(0)
    ids = np.array([1, 2])
    store.scatter(ids, _rows(rng, ids)[1])
    backend.fail_writes = True
    with pytest.raises(OSError, match="disk on fire"):
        store.scatter_async(ids, _rows(rng, ids)[1]).result()
    _await_poison(store)
    for call in (store.flush, lambda: store.gather(ids),
                 lambda: store.scatter_async(ids, _rows(rng, ids)[1]),
                 lambda: store.take("x", ids)):
        with pytest.raises(RuntimeError, match="poisoned") as info:
            call()
        assert isinstance(info.value.__cause__, OSError)
    store.close()  # still releases its resources


def test_flush_surfaces_a_worker_failure():
    store, backend = _failing()
    backend.fail_writes = True
    ids = np.array([0, 4])
    with pytest.raises((OSError, RuntimeError)):
        store.scatter_async(ids, _rows(np.random.default_rng(1), ids)[1])
        store.flush()
    store.close()


def test_a_shut_down_worker_is_a_clear_error_not_a_hang():
    store, _ = _failing()
    store._exec.shutdown(wait=True)
    ids = np.array([3])
    with pytest.raises(RuntimeError, match="worker is gone"):
        store.gather(ids)
    with pytest.raises(RuntimeError, match="worker is gone"):
        store.scatter_async(ids, _rows(np.random.default_rng(2), ids)[1])


def test_poison_does_not_leak_across_stores():
    bad, backend = _failing()
    good, _ = _pair("dense", tiered=True)
    rng = np.random.default_rng(3)
    ids = np.array([5])
    backend.fail_writes = True
    with pytest.raises((OSError, RuntimeError)):
        bad.scatter_async(ids, _rows(rng, ids)[1])
        bad.flush()
    jrows, rows = _rows(rng, ids)
    good.scatter_async(ids, rows)
    good.flush()
    _assert_same(good.gather(ids), jrows)
    _close(good, bad)


def test_stress_many_writers_under_a_short_switch_interval():
    """N threads (more than the cores here) each prefetch, write and take
    their own row of one store; every take must equal the row written
    last, and every write land."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    port, _ = _pair("dense", tiered=True, prefetch_depth=64)
    errors = []

    def work(i):
        try:
            row = np.array([i])
            for step in range(30):
                port.prefetch((i, step), row)
                rows = {"w": torch.full((1, 3), float(step)),
                        "m": torch.full((1, 2), float(i))}
                port.scatter_async(row, rows)
                got = port.take((i, step), row)
                assert got["w"][0, 0] == step and got["m"][0, 0] == i
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(N)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        port.flush()
        got = port.gather(np.arange(N))
        assert (got["w"][:, 0] == 29).all()
        assert torch.equal(got["m"][:, 0], torch.arange(N).float())
    finally:
        sys.setswitchinterval(switch)
        port.close()
