"""The launch plan of the fused local steps (B1, B2) and the wrapper's
cached validation, without a card.

``ops.update_plan`` is the code that plans the card's launches: the
chunks of each leaf, numbered across the dtype group, and the grid that
walks them. The tests hold it to covering every element of every leaf
exactly once; then a float32 emulation of the kernel's chunk walk (block
b takes chunks b, b + grid, ...; a chunk's full 8-element vectors, then
its scalar tail, or all of it scalar for a misaligned leaf; blocks in no
order) to the plain version's ``y'`` and ``m'``, bitwise: the kernel's
arithmetic is the plain version's, element for element. Last, the
wrapper's cache of validated trees, keyed by a signature without data
pointers, still raises on every change the first call would refuse.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.scaffold_update import ops, ref

VEC = 8  # elements a vector (kVec)
SIZES = (0, 1, 7, 62, 200_704)
WAVES = (1, 7, 132 * 5, 132 * 16)


def _random_sizes(rng, n_leaves):
    return [int(s) for s in rng.choice(SIZES, n_leaves)]


def _chunks(plan, sizes):
    """``(leaf, lo, hi)`` of every chunk, by chunk number."""
    out = []
    for leaf, n in enumerate(sizes):
        for j in range(plan.first[leaf + 1] - plan.first[leaf]):
            out.append((leaf, j * ops.CHUNK, min(n, (j + 1) * ops.CHUNK)))
    return out


def _block_walk(plan):
    """The chunks each block takes, in its order."""
    return {b: list(range(b, plan.first[-1], plan.grid))
            for b in range(plan.grid)}


@pytest.mark.parametrize("n_leaves", [1, 4, 83, 256])
@pytest.mark.parametrize("wave", WAVES)
def test_plan_covers_every_element_once(n_leaves, wave):
    rng = np.random.default_rng(n_leaves * 1000 + wave)
    sizes = _random_sizes(rng, n_leaves)
    plan = ops.update_plan(sizes, wave)
    assert plan.capacity == min(c for c in ops.CAPACITIES if c >= n_leaves)
    assert plan.first[0] == 0 and len(plan.first) == n_leaves + 1
    chunks = _chunks(plan, sizes)
    assert len(chunks) == plan.first[-1]
    # the grid: never more blocks than chunks or than a wave, and none idle
    assert plan.grid == min(len(chunks), wave)
    walked = sorted(ch for walk in _block_walk(plan).values() for ch in walk)
    assert walked == list(range(len(chunks)))
    assert all(_block_walk(plan).values())
    # every element of every leaf in exactly one chunk; a leaf's chunks
    # start at multiples of CHUNK elements, 16 B aligned in fp32 and bf16
    # when the leaf is
    covered = [np.zeros(n, np.int64) for n in sizes]
    for leaf, lo, hi in chunks:
        assert 0 <= lo < hi <= sizes[leaf]
        assert lo % ops.CHUNK == 0 and (lo * 2) % 16 == 0
        covered[leaf][lo:hi] += 1
    assert all((c == 1).all() for c in covered)
    assert all(plan.first[i + 1] - plan.first[i] == -(-n // ops.CHUNK)
               for i, n in enumerate(sizes))


def test_plan_edges():
    assert ops.CHUNK % VEC == 0
    assert ops.update_plan([0, 0], 132).grid == 0  # nothing to launch
    assert ops.update_plan([62], 132) == ops.UpdatePlan(4, (0, 1), 1)
    mlp = ops.update_plan([784 * 256, 256, 256 * 62, 62], 132 * 5)
    assert mlp.first[-1] == mlp.grid == 98 + 1 + 8 + 1
    assert ops.update_plan([1] * 4, 132).capacity == 4
    assert ops.update_plan([1] * 5, 132).capacity == 256
    with pytest.raises(ValueError, match="257 leaves"):
        ops.update_plan([1] * 257, 132)
    with pytest.raises(ValueError):
        ops.update_plan([], 132)


def _emulate(plan, y, g, c, m, aligned, eta, beta, order):
    """The kernel's chunk walk in float32 on the CPU, in place into y (and
    m), as the trainer calls it; returns how often each element was
    written."""
    eta32 = torch.tensor(eta, dtype=torch.float32)
    beta32 = torch.tensor(beta, dtype=torch.float32)
    writes = [torch.zeros(t.numel(), dtype=torch.int64) for t in y]
    chunks = _chunks(plan, [t.numel() for t in y])
    walks = _block_walk(plan)
    for b in order:
        for ch in walks[b]:
            leaf, lo, hi = chunks[ch]
            split = lo + (hi - lo) // VEC * VEC if aligned[leaf] else lo
            for a, z in ((lo, split), (split, hi)):  # vectors, then scalars
                if a == z:
                    continue
                yy, gg, cc = (t[leaf].view(-1)[a:z] for t in (y, g, c))
                gc = gg.float() + cc.float()
                if m is not None:
                    mm = m[leaf].view(-1)[a:z]
                    mm.copy_(beta32 * mm + gc)
                    gc = mm
                yy.copy_((yy.float() - eta32 * gc).to(yy.dtype))
                writes[leaf][a:z] += 1
    return writes


@pytest.mark.parametrize("slot", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_leaves,wave", [(1, 7), (4, 5), (13, 132 * 5)])
def test_emulated_chunk_walk_is_the_plain_version_bitwise(n_leaves, wave,
                                                          dtype, slot):
    rng = np.random.default_rng(n_leaves + wave)
    sizes = [int(s) for s in rng.choice((0, 1, 7, 62, 3 * ops.CHUNK + 5,
                                         20_000), n_leaves)]
    draw = lambda n, dt: torch.from_numpy(  # noqa: E731
        rng.standard_normal(n).astype(np.float32)).to(dt)
    y = [draw(n, dtype) for n in sizes]
    g = [draw(n, dtype) for n in sizes]
    c = [draw(n, torch.float32) for n in sizes]
    m = [draw(n, torch.float32) for n in sizes] if slot else None
    if slot:
        want = [ref.scaffold_momentum_update_ref(*a, 0.3, 0.9)
                for a in zip(y, g, c, m)]
    else:
        want = [(ref.scaffold_update_ref(*a, 0.3), None)
                for a in zip(y, g, c)]
    plan = ops.update_plan(sizes, wave)
    aligned = rng.random(n_leaves) < 0.7
    order = rng.permutation(plan.grid)  # blocks run in no order
    writes = _emulate(plan, y, g, c, m, aligned, 0.3, 0.9, order)
    assert all((w == 1).all() for w in writes)
    for i, (want_y, want_m) in enumerate(want):
        assert torch.equal(y[i], want_y), i
        if slot:
            assert torch.equal(m[i], want_m), i


def _cpu_trees(seed, sizes=(5, 62, 300)):
    gen = torch.Generator().manual_seed(seed)
    return [{f"l{i}": torch.randn(n, generator=gen)
             for i, n in enumerate(sizes)} for _ in range(4)]


def test_cache_keeps_one_entry_per_signature_and_ignores_data_pointers():
    y, g, c, _ = _cpu_trees(0)
    ops.scaffold_update_packed(y, g, c, 0.1, out=y, device="cpu")
    n_cached = len(ops._VALIDATED)
    for seed in (1, 2):  # fresh tensors, same signature: no new entry
        y2, g2, c2, _ = _cpu_trees(seed)
        want = {k: ref.scaffold_update_ref(y2[k], g2[k], c2[k], 0.1)
                for k in y2}
        ops.scaffold_update_packed(y2, g2, c2, 0.1, out=y2, device="cpu")
        assert len(ops._VALIDATED) == n_cached
        assert all(torch.equal(y2[k], want[k]) for k in y2)


def _changed(kind, t):
    if kind == "shape":
        return torch.zeros(t.numel() + 1)
    if kind == "dtype":
        return t.double()
    if kind == "device":
        return torch.zeros(t.shape, device="meta")
    if kind == "non-contiguous":
        return torch.zeros(2 * t.numel())[::2]
    raise AssertionError(kind)


@pytest.mark.parametrize("slot,role", [
    (False, "y"), (False, "g"), (False, "corr"),
    (True, "y"), (True, "g"), (True, "corr"), (True, "m")],
    ids=lambda v: {False: "B1", True: "B2"}.get(v, v))
@pytest.mark.parametrize("kind", ["shape", "dtype", "device",
                                  "non-contiguous"])
def test_cached_validation_still_raises_on_a_change(kind, slot, role):
    y, g, c, m = _cpu_trees(3)

    def call(y, g, c, m):
        if slot:
            return ops.scaffold_momentum_update_packed(y, g, c, m, 0.1, 0.9,
                                                       device="cpu")
        return ops.scaffold_update_packed(y, g, c, 0.1, device="cpu")

    call(y, g, c, m)  # the valid signature is cached
    trees = dict(y=y, g=g, corr=c, m=m)
    trees[role] = {**trees[role], "l1": _changed(kind, trees[role]["l1"])}
    with pytest.raises((ValueError, TypeError)):
        call(trees["y"], trees["g"], trees["corr"], trees["m"])
    call(y, g, c, m)  # and the valid tree still runs


def test_cached_validation_still_raises_on_a_changed_structure():
    y, g, c, _ = _cpu_trees(4)
    ops.scaffold_update_packed(y, g, c, 0.1, device="cpu")
    for bad in ({**g, "extra": torch.zeros(3)},
                {k: v for k, v in g.items() if k != "l0"}):
        with pytest.raises(ValueError, match="structure"):
            ops.scaffold_update_packed(y, bad, c, 0.1, device="cpu")
