"""The decomposition of the K-step loop kernels (B3, B4) over a
cooperative grid, on the CPU.

``csrc/local_loop.cu`` gives each of G blocks R consecutive entries I_b
of y (``megakernel.grid_shape``); a block computes ``(Am y)_I`` from its
row slab ``Am[I, :]`` and ``(Am^T y)_I`` from its column slab
``Am[:, I]``, updates y_I (and the slot m_I), and writes the partial
loss ``0.5 y_I.u_I + bm_I.y_I``; the loss of a step is the sum of the
partials in block order. ``grid_emulation`` below repeats that
arithmetic in float32 torch, all blocks side by side, and is held to
the port's plain version (rtol 1e-6: the same fp32 sums cut at other
places) and to the JAX package's Pallas loop in interpret mode (rtol
1e-5, as
``tests/test_torch_megakernel.py``). y_K and m_K are held relative to
their largest entry. Against the Pallas loop a loss is held relative to
the size of its two terms, ``|0.5 y.Am y| + |bm.y|``, of which it is the
difference (at d 1000 a loss of 0.58 from terms of -13.6 and 14.2, so
fp32 sums in any order sit ~1e-5 of the loss apart). Against the plain
version it is held to the bound of the fp32 sums' own error: both sides
sum the same d products ``0.5 y_i u_i + bm_i y_i`` (u the same matvec on
both), each in its own order (the plain version's ``torch.dot`` in the
order of the machine's BLAS), and a sum of d fp32 terms in any order is
within ``gamma_d * sum |term_i|`` of the exact one, ``gamma_d = d u / (1
- d u)``, u = 2^-24; the two losses lie within twice that. The plan's invariants
(``local_loop_plan``) are checked here too: the kernel itself runs only
on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.kernels.scaffold_update import megakernel as jmk
from repro_torch.data import make_similarity_quadratics
from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ref

H100_SMS = 132
OLD_LIMITS = {"B3": 13_496, "B4": 10_796}  # widest d of the one-block kernel


@pytest.fixture(autouse=True)
def one_thread():
    """One torch intra-op thread and one BLAS thread for numpy: the
    emulation is small, and under the suite's parallel workers numpy's
    linear algebra (``make_similarity_quadratics`` at d 1024) on every
    core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def grid_emulation(y, corr, eta, A, b, G, *, m=None, beta=0.0, terms=None,
                   abs_terms=None, drop_last_partial=False):
    """The grid kernel's arithmetic in float32 for a card of ``G`` SMs,
    its blocks side by side: block j owns entries [j R, (j + 1) R) (the
    last block the rest, zero-padded here: a zero adds nothing to a
    sum). Each step takes every block's slab products, its partial loss
    ``0.5 y_I.u_I + bm_I.y_I`` summed over its own entries, and the
    step's loss as the fp32 sum of the partials in block order. Returns
    ``(y_K, m_K | None, losses)``; appends each step's ``|0.5 y.Am y| +
    |bm.y|`` to the list ``terms`` and its ``sum_i |0.5 y_i u_i| + |bm_i
    y_i|`` (float64) to ``abs_terms``, if given. ``drop_last_partial``
    leaves the last block's partial out of each loss (a fault, for the
    negative control)."""
    d, K = y.shape[0], A.shape[0]
    grid, R = mk.grid_shape(d, G)

    def blocks(t):  # (d,) -> (grid, R)
        return torch.nn.functional.pad(t, (0, grid * R - d)).view(grid, R)

    Am = A.float().mean(dim=1)
    bm = b.float().mean(dim=1)
    c32 = torch.zeros(d) if corr is None else corr.float()
    mm = None if m is None else m.float().clone()
    y32 = y.float()
    losses = []
    for k in range(K):
        u = Am[k] @ y32        # the row slabs, all blocks at once
        v = Am[k].T @ y32      # the column slabs, transposed
        yb = blocks(y32)
        q = 0.5 * (blocks(u) * yb).sum(dim=1)
        li = (blocks(bm[k]) * yb).sum(dim=1)
        # the partials summed one after another in fp32, in block order
        part = (q + li).numpy()[:grid - 1 if drop_last_partial else grid]
        losses.append(torch.tensor(np.add.accumulate(part)[-1]))
        if terms is not None:
            terms.append(abs(sum(q.tolist())) + abs(sum(li.tolist())))
        if abs_terms is not None:
            abs_terms.append(float((0.5 * u.double() * y32.double()).abs().sum()
                                   + (bm[k].double() * y32.double()).abs()
                                   .sum()))
        g = 0.5 * (u + v) + bm[k] + c32
        if mm is not None:
            mm = beta * mm + g
            g = mm
        y32 = (y32 - eta[k] * g).to(y.dtype).float()
    return y32.to(y.dtype), mm, torch.stack(losses)


def _inputs(d, K, bsz, slot, seed=0):
    rng = np.random.default_rng(seed)
    z = dict(
        y=rng.standard_normal(d).astype(np.float32),
        corr=(0.1 * rng.standard_normal(d)).astype(np.float32),
        A=(rng.standard_normal((K, bsz, d, d)) / np.sqrt(d)).astype(
            np.float32),
        b=rng.standard_normal((K, bsz, d)).astype(np.float32),
        eta=np.linspace(0.1, 0.05, K).astype(np.float32),
        m=rng.standard_normal(d).astype(np.float32) if slot else None)
    return z


def _torch(z):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in z.items()}


def _close(got, want, rtol, scale=None):
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    return np.abs(a - b).max() <= rtol * max(scale, 1e-30)


def _all_close(got, want, rtol, terms=None, abs_terms=None):
    """y_K, m_K to rtol of their largest entry; the losses to rtol of
    their largest terms, or, given ``abs_terms``, each within twice the
    error bound of an fp32 sum of its d products (the module's
    docstring)."""
    for what, g, w in zip(("y_K", "m_K"), got, want):
        assert (g is None) == (w is None), what
        if g is not None:
            assert tuple(g.shape) == tuple(w.shape), what
            assert _close(g, w, rtol), what
    g, w = np.asarray(got[2], np.float64), np.asarray(want[2], np.float64)
    assert g.shape == w.shape
    if abs_terms is None:
        assert _close(g, w, rtol, max(terms)), "losses"
        return
    d = got[0].shape[0]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    bound = 2 * gamma * np.asarray(abs_terms)
    assert (np.abs(g - w) <= bound).all(), ("losses", np.abs(g - w), bound)


CASES = [(d, bsz, K, slot) for d in (20, 1000, 1024) for bsz in (1, 2)
         for K in (1, 10) for slot in (False, True)]


@functools.lru_cache(maxsize=None)
def _jax_loop(d, bsz, K, slot):
    """The JAX package's Pallas loop in interpret mode on ``_inputs``."""
    z = _inputs(d, K, bsz, slot)
    kw = dict(m={"x": jnp.asarray(z["m"])}, beta=0.9) if slot else {}
    yj, mj, lj = jmk.scaffold_local_loop(
        {"x": jnp.asarray(z["y"])}, {"x": jnp.asarray(z["corr"])},
        {"A": jnp.asarray(z["A"]), "b": jnp.asarray(z["b"])},
        jnp.asarray(z["eta"]), interpret=True, **kw)
    return (np.asarray(yj["x"]), None if mj is None else np.asarray(mj["x"]),
            np.asarray(lj))


@pytest.mark.parametrize("G", [1, 7, 128, 132])
@pytest.mark.parametrize("d,bsz,K,slot", CASES)
def test_grid_emulation_matches_plain(G, d, bsz, K, slot):
    t = _torch(_inputs(d, K, bsz, slot))
    beta = 0.9 if slot else 0.0
    abs_terms = []
    got = grid_emulation(t["y"], t["corr"], t["eta"], t["A"], t["b"], G,
                         m=t["m"], beta=beta, abs_terms=abs_terms)
    want = ref.scaffold_local_loop_ref(t["y"], t["corr"], t["eta"], t["A"],
                                       t["b"], m=t["m"], beta=beta)
    assert got[0].dtype == want[0].dtype and len(abs_terms) == K
    _all_close(got, want, 1e-6, abs_terms=abs_terms)


@pytest.mark.parametrize("what,fails", [
    ("eta", "y_K"), ("corr", "y_K"), ("last_partial", "losses")])
def test_grid_emulation_check_rejects_a_wrong_step(what, fails):
    """The negative controls: the emulation with eta 1 % off, or without
    the correction, fails y_K against the plain version; with its last
    block's partial left out of each loss (y_K right), the losses."""
    t = _torch(_inputs(1024, 10, 1, False))
    eta = t["eta"] * 1.01 if what == "eta" else t["eta"]
    corr = None if what == "corr" else t["corr"]
    abs_terms = []
    got = grid_emulation(t["y"], corr, eta, t["A"], t["b"], 7,
                         abs_terms=abs_terms,
                         drop_last_partial=what == "last_partial")
    want = ref.scaffold_local_loop_ref(t["y"], t["corr"], t["eta"], t["A"],
                                       t["b"])
    with pytest.raises(AssertionError, match=fails):
        _all_close(got, want, 1e-6, abs_terms=abs_terms)


@pytest.mark.parametrize("d,bsz,K,slot", CASES)
def test_grid_emulation_matches_pallas_interpret(d, bsz, K, slot):
    t = _torch(_inputs(d, K, bsz, slot))
    want = _jax_loop(d, bsz, K, slot)
    for G in (1, 7, 128, 132):
        terms = []
        got = grid_emulation(t["y"], t["corr"], t["eta"], t["A"], t["b"], G,
                             m=t["m"], beta=0.9 if slot else 0.0,
                             terms=terms)
        _all_close(got, want, 1e-5, terms)


@pytest.mark.parametrize("sm_count", [1, 7, 114, 128, 132])
def test_owned_sets_cover_every_entry_once(sm_count):
    for d in list(range(1, 300)) + [999, 1000, 1001, 1024, 3000, 13_496]:
        grid, R = mk.grid_shape(d, sm_count)
        assert 1 <= grid <= min(sm_count, d)
        owners = np.zeros(d, np.int64)
        for blk in range(grid):
            lo, hi = blk * R, min(d, (blk + 1) * R)
            assert hi > lo  # every block owns at least one entry
            owners[lo:hi] += 1
        assert (owners == 1).all()


@pytest.mark.parametrize("kernel", sorted(OLD_LIMITS))
def test_plan_fits_every_width_the_one_block_kernel_took(kernel):
    """Shared memory within SMEM_LIMIT and G <= the SM count for every d
    the one-block kernel took, both layouts, on an H100 SXM
    (132 SMs) and PCIe (114)."""
    for sms in (H100_SMS, 114):
        for d in range(1, OLD_LIMITS[kernel] + 1):
            for a_sk in (0, d * d):
                plan = mk.local_loop_plan(d, 10, a_sk, sms)
                assert plan.smem_bytes <= mk.SMEM_LIMIT
                assert plan.smem_bytes == mk.smem_bytes(plan.rows, plan.chunk)
                assert 1 <= plan.grid <= sms
                assert (plan.grid - 1) * plan.rows < d <= plan.grid * plan.rows
                assert 1 <= plan.chunk <= d
                assert plan.chunk == d or not plan.resident


def test_plan_is_resident_for_the_trainers_broadcast_view():
    """The trainer's quadratics batches at d 1024 are a stride-0 view of
    one client's A: the slabs load once, 128 blocks of 8 entries."""
    ds = make_similarity_quadratics(4, 1024, delta=0.3, G=8.0, mu=0.3)
    view = ds.round_batches(np.array([0, 1]), 10, 1, None, device="cpu")
    A = view["A"][0]
    assert A.shape == (10, 1, 1024, 1024) and A.stride(0) == 0
    plan = mk.local_loop_plan(1024, 10, A.stride(0), H100_SMS)
    assert plan.resident
    assert (plan.grid, plan.rows, plan.chunk) == (128, 8, 1024)
    assert plan.smem_bytes == 70_080


def test_plan_streams_a_fresh_A():
    fresh = mk.local_loop_plan(1024, 10, 1024 * 1024, H100_SMS)
    assert not fresh.resident and fresh.chunk == 1024 and fresh.grid == 128
    # one step of A alone is resident whatever its stride
    assert mk.local_loop_plan(1024, 1, 1024 * 1024, H100_SMS).resident
    # beyond the resident width both layouts stream, in several chunks
    for a_sk in (0, 3000 * 3000):
        wide = mk.local_loop_plan(3000, 2, a_sk, H100_SMS)
        assert not wide.resident and wide.chunk < 3000
        assert wide.chunk % mk.MIN_CHUNK == 0


def test_plan_refuses_what_no_chunk_fits():
    lo, hi = OLD_LIMITS["B3"], 1_000_000  # lo fits, hi does not
    assert _fits(lo) and not _fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits(mid) else (lo, mid)
    with pytest.raises(ValueError, match="shared memory"):
        mk.local_loop_plan(hi, 10, 0, H100_SMS)
    assert all(not _fits(d) for d in (hi, hi + 1, 2 * hi))


def _fits(d):
    try:
        mk.local_loop_plan(d, 10, 0, H100_SMS)
    except ValueError:
        return False
    return True
