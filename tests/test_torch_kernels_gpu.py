"""The port's CUDA kernels on the card, against their plain versions.

These run only where ``torch.cuda.is_available()`` (marker ``gpu``) and
import nothing of JAX, so they run on a GPU machine without it:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Bounds: the fused corrected and heavy-ball updates (B1, B2) within 1 ulp
of y's dtype and 0 ulp of the fp32 slot (they round each operation as
the plain versions do); the K-step loops (B3, B4) in fp32 to rtol 1e-5
(sums in another order), on a cooperative grid of more than one block,
two launches bitwise equal; sliding-window attention (B5) in fp32 to 2e-5
absolute, in bf16 to 1 bf16 ulp of the plain element plus 2e-5 (both
round an fp32 result once; the fp32 results differ by the order of their
sums, which exceeds an ulp only below 2^-8). B1 and B2 also run on a
LoRA delta tree as the trainer stacks it and B1 on one hymba layer's
mixed bf16/fp32 tree (one launch a dtype group), and a bf16 checkpoint
round-trips on the card bitwise. The scanned engine's rounds, captured
as CUDA graphs around B1-B5, equal the eager host loop on the same
device streams (bitwise; the W layer within 1e-4), and the launch counts
follow the graph's replays. The async engine's degenerate limit equals
the synchronous loop on the card bitwise through B1, B2 and B3 with the
same launches, and under stragglers its tiered store equals the dense
one and a mid-buffer checkpoint resumes bitwise. The fp32 grouped
product of the routed experts (G1) equals its plain version forward and
backward, bf16 takes ``torch._grouped_mm``, an MoE decode step makes no
host sync, and the reduced MoE's rounds under the ragged dispatch repeat
bitwise in fp32 and bf16: run again, resumed, pipelined and tiered.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402  the card script's own tables
    B12_CASES,
    G1_BOUND,
    G1_CASES,
)
from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ops, ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention import ref as swa_ref

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_a_card():
    # decided when a test runs, never at import: every test of this file
    # is collected alike on every machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in units of the last place (fp32 or bf16)."""
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    bits = 31 if a.dtype == torch.float32 else 15
    ia, ib = (t.contiguous().view(ity).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & ((1 << bits) - 1)), ia)
    ib = torch.where(ib < 0, -(ib & ((1 << bits) - 1)), ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 9, 100_003])
def test_scaffold_update_matches_plain(dtype, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    y, g, c = (torch.randn(n, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = ops.LAUNCHES["scaffold_update"]
    out = ops.scaffold_update(y, g, c, 0.05)
    assert ops.LAUNCHES["scaffold_update"] == before + 1
    assert ulp_distance(out, ref.scaffold_update_ref(y, g, c, 0.05)) <= 1


def test_scaffold_update_unaligned_views_take_the_scalar_path():
    base = torch.randn(1001, device="cuda")
    y, g, c = base[1:], base[:-1].clone(), base[:-1].clone()  # y off by 4 B
    out = ops.scaffold_update(y, g, c, 0.1)
    assert ulp_distance(out, ref.scaffold_update_ref(y, g, c, 0.1)) <= 1


def test_scaffold_update_packed_one_launch_for_a_large_tree():
    """gemma3-1b's tree has 83 leaves in one dtype group: one launch."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    y, g, c = ({f"w{i}": torch.randn(97 + i, generator=gen, device="cuda")
                for i in range(ops.MAX_LEAVES)} for _ in range(3))
    want = {k: ref.scaffold_update_ref(y[k], g[k], c[k], 0.1) for k in y}
    before = ops.LAUNCHES["scaffold_update"]
    ops.scaffold_update_packed(y, g, c, 0.1, out=y)
    assert ops.LAUNCHES["scaffold_update"] == before + 1
    assert all(ulp_distance(y[k], want[k]) <= 1 for k in y)


@pytest.mark.parametrize("d", [20, 1000, 1024])
@pytest.mark.parametrize("bsz", [1, 2])
def test_local_loop_matches_plain(d, bsz):
    gen = torch.Generator(device="cuda").manual_seed(d + bsz)
    K = 10
    y = torch.randn(d, generator=gen, device="cuda")
    corr = 0.1 * torch.randn(d, generator=gen, device="cuda")
    A = torch.randn((K, bsz, d, d), generator=gen, device="cuda") / math.sqrt(d)
    b = torch.randn((K, bsz, d), generator=gen, device="cuda")
    eta = torch.linspace(0.1, 0.05, K, device="cuda")
    before = ops.LAUNCHES["scaffold_local_loop"]
    yk, mk_, lk = mk.scaffold_local_loop_cuda(y, corr, eta, A, b)
    assert ops.LAUNCHES["scaffold_local_loop"] == before + 1 and mk_ is None
    yp, _, lp = ref.scaffold_local_loop_ref(y, corr, eta, A, b)
    assert float((yk - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    assert float((lk - lp).abs().max()) <= 1e-5 * float(lp.abs().max())


def test_local_loop_broadcast_views():
    """The trainer's stride-0 K/bsz views give the dense copy's result."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    d = 64
    A1 = torch.randn((d, d), generator=gen, device="cuda") / math.sqrt(d)
    b1 = torch.randn(d, generator=gen, device="cuda")
    A, b = A1[None, None].expand(10, 2, d, d), b1[None, None].expand(10, 2, d)
    y = torch.randn(d, generator=gen, device="cuda")
    eta = torch.full((10,), 0.1, device="cuda")
    ya, _, la = mk.scaffold_local_loop_cuda(y, None, eta, A, b)
    yb, _, lb = mk.scaffold_local_loop_cuda(y, None, eta, A.contiguous(),
                                            b.contiguous())
    assert torch.equal(ya, yb) and torch.equal(la, lb)


def _loop_inputs(d, K, bsz, layout, seed):
    """y, corr, slot m, eta and A, b: a distinct A_k a step ("fresh") or
    one (d, d) matrix viewed at stride 0 ("broadcast", the trainer's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(d, generator=gen, device="cuda")
    corr = 0.1 * torch.randn(d, generator=gen, device="cuda")
    m = torch.randn(d, generator=gen, device="cuda")
    eta = torch.linspace(0.1, 0.05, K, device="cuda")
    if layout == "fresh":
        A = torch.randn((K, bsz, d, d), generator=gen,
                        device="cuda") / math.sqrt(d)
        b = torch.randn((K, bsz, d), generator=gen, device="cuda")
    else:
        A = (torch.randn((d, d), generator=gen, device="cuda")
             / math.sqrt(d))[None, None].expand(K, bsz, d, d)
        b = torch.randn(d, generator=gen, device="cuda")[None, None].expand(
            K, bsz, d)
    return y, corr, m, eta, A, b


def _loop_plan(d, K, A):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return mk.local_loop_plan(d, K, A.stride(0), sms)


def _assert_loop_close(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert float((g - w).abs().max()) <= 1e-5 * float(
                w.abs().max())


@pytest.mark.parametrize("slot", [False, True], ids=["B3", "B4"])
@pytest.mark.parametrize("d", [20, 1000, 1024, 3000])
@pytest.mark.parametrize("layout", ["fresh", "broadcast"])
def test_local_loop_grid_matches_plain(layout, d, slot):
    """Both layouts, resident (broadcast up to d 1024) and streaming (fresh
    A, and d 3000 in chunks), on a grid of more than one block."""
    K = 10 if d <= 1024 else 2
    y, corr, m, eta, A, b = _loop_inputs(d, K, 2, layout, d + slot)
    kw = dict(m=m, beta=0.9) if slot else {}
    name = "scaffold_momentum_local_loop" if slot else "scaffold_local_loop"
    plan = _loop_plan(d, K, A)
    assert plan.grid > 1
    assert plan.resident == (layout == "broadcast" and d <= 1024)
    before, planned = ops.LAUNCHES[name], mk.PLANS[name][plan]
    got = mk.scaffold_local_loop_cuda(y, corr, eta, A, b, **kw)
    assert ops.LAUNCHES[name] == before + 1
    assert mk.PLANS[name][plan] == planned + 1
    _assert_loop_close(got, ref.scaffold_local_loop_ref(y, corr, eta, A, b,
                                                        **kw))


@pytest.mark.parametrize("slot", [False, True], ids=["B3", "B4"])
@pytest.mark.parametrize("d,layout", [(1024, "broadcast"), (1024, "fresh"),
                                      (3000, "fresh")])
def test_local_loop_grid_is_deterministic(d, layout, slot):
    """No atomics: two launches give the same bits, losses included."""
    K = 10 if d <= 1024 else 2
    y, corr, m, eta, A, b = _loop_inputs(d, K, 2, layout, 5)
    kw = dict(m=m, beta=0.9) if slot else {}
    one = mk.scaffold_local_loop_cuda(y, corr, eta, A, b, **kw)
    two = mk.scaffold_local_loop_cuda(y, corr, eta, A, b, **kw)
    for a, c in zip(one, two):
        assert (a is None and c is None) or torch.equal(a, c)


@pytest.mark.parametrize("d", [133, 1001, 2003])
def test_local_loop_grid_with_a_partial_last_block(d):
    """d not a multiple of the grid: the last block owns fewer entries."""
    y, corr, m, eta, A, b = _loop_inputs(d, 3, 1, "broadcast", d)
    plan = _loop_plan(d, 3, A)
    assert plan.grid * plan.rows > d and plan.grid > 1
    for kw in ({}, dict(m=m, beta=0.9)):
        _assert_loop_close(
            mk.scaffold_local_loop_cuda(y, corr, eta, A, b, **kw),
            ref.scaffold_local_loop_ref(y, corr, eta, A, b, **kw))


def test_local_loop_refuses_a_width_no_plan_fits():
    """The first width whose slab chunk cannot fit a block's shared
    memory raises before anything launches; nothing falls back."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = 1000
    while True:
        try:
            mk.local_loop_plan(d, 1, 0, sms)
        except ValueError:
            break
        d += 1000
    lo = d - 1000
    while d - lo > 1:  # the first refused width in (lo, d]
        mid = (lo + d) // 2
        try:
            mk.local_loop_plan(mid, 1, 0, sms)
            lo = mid
        except ValueError:
            d = mid
    A = torch.empty((1, 1, d, d), dtype=torch.bfloat16, device="cuda")
    b = torch.zeros((1, 1, d), device="cuda")
    y = torch.zeros(d, device="cuda")
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        mk.scaffold_local_loop_cuda(y, None, [0.1], A, b)
    assert ops.LAUNCHES == before
    del A
    torch.cuda.empty_cache()


def test_local_loop_refuses_a_grid_that_cannot_be_co_resident(monkeypatch):
    """A plan for a card of 10,000 SMs asks for 10,000 co-resident blocks:
    the cooperative launch is refused, the wrapper raises and counts no
    launch."""
    monkeypatch.setattr(mk, "_sm_count", lambda device: 10_000)
    y, corr, _, eta, A, b = _loop_inputs(10_000, 1, 1, "broadcast", 9)
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="co-resident"):
        mk.scaffold_local_loop_cuda(y, corr, eta, A, b)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 9, 100_003])
def test_scaffold_momentum_update_matches_plain(dtype, n):
    gen = torch.Generator(device="cuda").manual_seed(n + 1)
    y, g, c = (torch.randn(n, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    m = torch.randn(n, generator=gen, device="cuda")
    before = ops.LAUNCHES["scaffold_momentum_update"]
    yo, mo = ops.scaffold_momentum_update(y, g, c, m, 0.05, 0.9)
    assert ops.LAUNCHES["scaffold_momentum_update"] == before + 1
    yp, mp = ref.scaffold_momentum_update_ref(y, g, c, m, 0.05, 0.9)
    assert ulp_distance(mo, mp) == 0 and ulp_distance(yo, yp) <= 1


def test_scaffold_momentum_update_in_place_mixed_tree():
    """One launch per (y, g, corr, m) dtype group, y and m in place, an
    unaligned leaf on the scalar path."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = torch.randn(1001, device="cuda")
    y = {"a": torch.randn(4099, device="cuda").to(bf16), "b": base[1:],
         "c": torch.randn(77, device="cuda")}
    g = {"a": torch.randn(4099, device="cuda").to(bf16),
         "b": torch.randn(1000, device="cuda").to(bf16),
         "c": torch.randn(77, device="cuda").to(bf16)}
    c = {k: torch.randn(v.shape, device="cuda").to(
        bf16 if k == "a" else f32) for k, v in y.items()}
    m = {k: torch.randn(v.shape, device="cuda") for k, v in y.items()}
    want = ref.scaffold_momentum_update_tree_ref(y, g, c, m, 0.1, 0.9)
    before = ops.LAUNCHES["scaffold_momentum_update"]
    ops.scaffold_momentum_update_packed(y, g, c, m, 0.1, 0.9, out=y,
                                        m_out=m)
    assert ops.LAUNCHES["scaffold_momentum_update"] == before + 2
    for k in y:
        assert ulp_distance(y[k], want[0][k]) <= 1
        assert ulp_distance(m[k], want[1][k]) == 0


@pytest.mark.parametrize("d", [20, 1000, 1024])
@pytest.mark.parametrize("bsz", [1, 2])
def test_momentum_local_loop_matches_plain(d, bsz):
    gen = torch.Generator(device="cuda").manual_seed(10 * d + bsz)
    K = 10
    y = torch.randn(d, generator=gen, device="cuda")
    corr = 0.1 * torch.randn(d, generator=gen, device="cuda")
    m = torch.randn(d, generator=gen, device="cuda")
    A = torch.randn((K, bsz, d, d), generator=gen, device="cuda") / math.sqrt(d)
    b = torch.randn((K, bsz, d), generator=gen, device="cuda")
    eta = torch.linspace(0.1, 0.05, K, device="cuda")
    before = ops.LAUNCHES["scaffold_momentum_local_loop"]
    yk, mk_, lk = mk.scaffold_local_loop_cuda(y, corr, eta, A, b, m=m,
                                              beta=0.9)
    assert ops.LAUNCHES["scaffold_momentum_local_loop"] == before + 1
    yp, mp, lp = ref.scaffold_local_loop_ref(y, corr, eta, A, b, m=m,
                                             beta=0.9)
    for got, want in ((yk, yp), (mk_, mp), (lk, lp)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


# (B, S, Hq, Hkv, D, window): the JAX package's kernel test shapes,
# gemma3-1b's "W" layer at seq 2048, a ragged S and window, and the bf16
# kernel's tiling edges at D 256 and 64: S and W not multiples of the
# 64-row tiles, W >= S, batch 2 with 4 query heads a kv head; hymba-1.5b's
# "Y" attention at seq 2048, batch 1 and 2 (25q/5kv x 64, window 1024)
SWA_CASES = [(1, 512, 2, 1, 64, 128), (2, 256, 4, 4, 32, 64),
             (1, 384, 6, 3, 64, 128), (2, 128, 2, 1, 128, 64),
             (1, 2048, 4, 1, 256, 512), (1, 200, 2, 1, 32, 50),
             (1, 1000, 4, 1, 256, 300), (1, 1000, 4, 1, 64, 300),
             (1, 300, 4, 1, 256, 512), (1, 300, 2, 1, 64, 300),
             (2, 512, 4, 1, 256, 128), (2, 1000, 8, 2, 64, 300),
             (1, 2048, 25, 5, 64, 1024), (2, 2048, 25, 5, 64, 1024)]


def _swa_plain(q, k, v, w):
    return swa_ref.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), w).transpose(1, 2)


def _within_bf16_bound(got, want):
    """|got - want| <= 1 bf16 ulp of want, plus 2e-5, elementwise."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got - want).abs() <= ulp + 2e-5).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SWA_CASES, ids=str)
def test_swa_attention_matches_plain(case, dtype):
    b, s, hq, hkv, d, w = case
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(
        dtype) for _ in range(2))
    before = swa_ops.LAUNCHES["swa_attention"]
    got = swa_ops.swa_attention_cuda(q, k, v, w)
    assert swa_ops.LAUNCHES["swa_attention"] == before + 1
    want = _swa_plain(q, k, v, w)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert _within_bf16_bound(got, want)


@pytest.mark.parametrize("d", [64, 256])
def test_swa_attention_reads_strided_views_of_a_fused_qkv(d):
    """q, k and v as head slices of one (B, S, Hq + 2 Hkv, D) projection:
    the head dim contiguous, the other strides those of the fused tensor
    (16-byte multiples, as TMA wants)."""
    b, s, hq, hkv, w = 2, 1000, 4, 1, 300
    gen = torch.Generator(device="cuda").manual_seed(d)
    qkv = torch.randn((b, s, hq + 2 * hkv, d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split([hq, hkv, hkv], dim=2)
    assert not q.is_contiguous() and k.stride() == qkv.stride()
    got = swa_ops.swa_attention_cuda(q, k, v, w)
    assert _within_bf16_bound(got, _swa_plain(q, k, v, w))


def test_swa_attention_op_backward_matches_the_cpu_op():
    """Forward through the kernel (one launch), backward through the
    recomputed model layer, against the same op on the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = ((2, 256, 4, 32), (2, 256, 2, 32), (2, 256, 2, 32))
    xs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    cot = torch.randn(shapes[0], generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in xs]
        before = swa_ops.LAUNCHES["swa_attention"]
        out = swa_ops.swa_attention(*leaves, 64)
        assert swa_ops.LAUNCHES["swa_attention"] == before + (dev == "cuda")
        grads[dev] = torch.autograd.grad(out, leaves, cot.to(dev))
    for gc, gp in zip(grads["cuda"], grads["cpu"]):
        assert float((gc.cpu() - gp).abs().max()) <= 1e-5 * float(
            gp.abs().max())


def test_w_layer_takes_the_kernel_on_the_band_path_only():
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = get_reduced("gemma3-1b")  # window 64
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    attn = {k: v[0] for k, v in T.sub(params, "layers/0/attn").items()}
    for s, launches in ((128, 1), (64, 0), (96, 0)):
        x = torch.randn((1, s, cfg.d_model), device="cuda")
        pos = torch.arange(s, device="cuda")[None]
        before = swa_ops.LAUNCHES["swa_attention"]
        L.attention_block(cfg, attn, x, pos, kind="W")
        assert swa_ops.LAUNCHES["swa_attention"] == before + launches, s


def test_swa_attention_refuses_what_the_kernel_cannot_take():
    q = torch.randn((1, 64, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        swa_ops.swa_attention_cuda(q, q, q, 16)
    wide = torch.randn((1, 64, 2, 128), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        swa_ops.swa_attention_cuda(wide, wide, wide, 16)
    half = torch.randn((1, 64, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        swa_ops.swa_attention_cuda(half, half, half, 16)


def test_swa_attention_refuses_what_tma_cannot_read():
    """bf16 tiles come in through TMA: a base off 16 bytes, or a stride
    that is no multiple of 16 bytes, raises; nothing falls back."""
    flat = torch.randn(1 + 64 * 2 * 64, device="cuda").to(torch.bfloat16)
    off = flat[1:].view(1, 64, 2, 64)  # base 2 bytes past an aligned one
    ok = flat[:-1].view(1, 64, 2, 64).clone()
    before = swa_ops.LAUNCHES["swa_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        swa_ops.swa_attention_cuda(off, ok, ok, 16)
    padded = torch.randn((1, 64, 2, 68), device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        swa_ops.swa_attention_cuda(ok, padded[..., :64], ok, 16)
    assert swa_ops.LAUNCHES["swa_attention"] == before


# ------------------------------------------------- the EMNIST slice


def _mlp_tree(gen, dev="cuda"):
    """The EMNIST MLP's leaves (784-256-62), fp32."""
    shapes = {"b1": (256,), "b2": (62,), "w1": (784, 256), "w2": (256, 62)}
    return {k: torch.randn(s, generator=gen, device=dev)
            for k, s in shapes.items()}


def test_scaffold_update_at_the_mlp_tree_is_exact():
    gen = torch.Generator(device="cuda").manual_seed(11)
    y, g, c = (_mlp_tree(gen) for _ in range(3))
    before = ops.LAUNCHES["scaffold_update"]
    out = ops.scaffold_update_packed(y, g, c, 0.3)
    assert ops.LAUNCHES["scaffold_update"] == before + 1
    for k in y:
        assert ulp_distance(out[k], ref.scaffold_update_ref(
            y[k], g[k], c[k], 0.3)) == 0, k


def test_scaffold_momentum_update_at_the_mlp_tree_is_exact():
    """B2 on the MLP tree with an fp32 slot, as scaffold_m's local
    heavy-ball runs it: 1 ulp in y', 0 ulp in m' (the bounds of the
    other B2 card tests)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    y, g, c, m = (_mlp_tree(gen) for _ in range(4))
    before = ops.LAUNCHES["scaffold_momentum_update"]
    out_y, out_m = ops.scaffold_momentum_update_packed(y, g, c, m, 0.3, 0.9)
    assert ops.LAUNCHES["scaffold_momentum_update"] == before + 1
    want_y, want_m = ref.scaffold_momentum_update_tree_ref(y, g, c, m, 0.3,
                                                           0.9)
    for k in y:
        assert ulp_distance(out_y[k], want_y[k]) <= 1, k
        assert ulp_distance(out_m[k], want_m[k]) == 0, k


def _emnist_trainer(dev, fused=True, **changes):
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import EmnistLikeFederated
    from repro_torch.models import simple

    data = EmnistLikeFederated(10, 2000, 10.0, seed=0, test_samples=100)
    spec = FedRoundSpec(**{**dict(
        algorithm="scaffold", num_clients=10, num_sampled=4, local_steps=5,
        local_batch=data.local_batch_size(0.2), eta_l=0.3), **changes})
    init = simple.mlp_init(torch.Generator().manual_seed(0), 784, 62,
                           device="cpu")
    return FederatedTrainer(simple.mlp_loss,
                            lambda gen: {k: v.clone() for k, v in
                                         init.items()},
                            spec, data, seed=0, use_fused_update=fused,
                            device=dev)


@pytest.mark.parametrize("algo,want", [("scaffold", 2 * 4 * 5),
                                       ("fedavg", 0)])
def test_emnist_round_launches_b1_on_every_corrected_step(algo, want):
    tr = _emnist_trainer("cuda", algorithm=algo)
    ops.reset_launches()
    for _ in range(2):
        m = tr.run_round()
    assert math.isfinite(m["loss"])
    assert ops.LAUNCHES["scaffold_update"] == want
    assert sum(ops.LAUNCHES.values()) == want


def test_emnist_heavy_ball_round_launches_b2_and_matches_the_cpu():
    """scaffold_m with local heavy-ball: B2 on every local step (S x K a
    round, nothing else launched), x and the slot rows bitwise equal to
    the card's plain update, and x within 1e-4 of the CPU's."""
    import numpy as np

    kw = dict(algorithm="scaffold_m", local_solver="momentum",
              local_momentum=0.9)
    out = {}
    for tag, dev, fused in (("B2", "cuda", True), ("plain", "cuda", False),
                            ("cpu", "cpu", True)):
        tr = _emnist_trainer(dev, fused=fused, **kw)
        ops.reset_launches()
        m = tr.run_round()
        assert math.isfinite(m["loss"])
        want = 4 * 5 if tag == "B2" else 0
        assert ops.LAUNCHES["scaffold_momentum_update"] == want
        assert sum(ops.LAUNCHES.values()) == want
        out[tag] = ({k: v.cpu() for k, v in tr.x.items()},
                    tr.solver_store.gather(np.arange(10)))
    (xb, mb), (xp, mp), (xc, _) = out["B2"], out["plain"], out["cpu"]
    for k in xb:
        assert torch.equal(xb[k], xp[k]), k
    for k in mb:
        assert torch.equal(mb[k], mp[k]), k
    for k, v in xc.items():
        assert (xb[k] - v).abs().max() <= 1e-4 * v.abs().max(), k


def test_codec_and_privacy_round_on_the_card_matches_the_cpu():
    """int8 both ways + server noise (normals from numpy at the fold
    paths, on both devices): x within 1e-4 of the CPU's after one round,
    the residual rows alike, the bytes and dp_epsilon equal."""
    import numpy as np

    from repro_torch.core import streams

    def normals(kind, path, shape):
        return np.random.default_rng(list(path)).standard_normal(
            shape, dtype=np.float32)

    kw = dict(compress="int8_ef", compress_downlink="int8_ef",
              privatizer="server_gauss", clip_norm=1.0, noise_multiplier=1.0)
    out = {}
    with streams.injected(normals):
        for dev in ("cuda", "cpu"):
            tr = _emnist_trainer(dev, **kw)
            m = tr.run_round()
            rows = tr.residual_store.gather(np.arange(10))
            out[dev] = (m, {k: v.cpu() for k, v in tr.x.items()}, rows)
    (mc, xc, rc), (mh, xh, rh) = out["cuda"], out["cpu"]
    for k in ("bytes_up", "bytes_down", "dp_epsilon"):
        assert mc[k] == mh[k], k
    for k, v in xh.items():
        assert (xc[k] - v).abs().max() <= 1e-4 * v.abs().max(), k
    assert any(v.any() for v in rc.values())


# ------------------------------------- B1 and B2 on a flat grid of chunks


def _leaf_trees(sizes, dtype, seed, views=(), corr_dtype=None):
    """y, g, corr and an fp32 slot m of leaves ``l<i>`` with ``sizes``
    elements (corr in ``corr_dtype``, by default y's); the leaves whose
    index is in ``views`` are 4 bytes past an aligned base (misaligned
    views)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    trees = [{}, {}, {}, {}]
    for i, n in enumerate(sizes):
        for t, dt in zip(trees, (dtype, dtype, corr_dtype or dtype,
                                 torch.float32)):
            base = torch.randn(n + 1, generator=gen, device="cuda").to(dt)
            t[f"l{i}"] = base[1:] if i in views else base[:n].clone()
    return trees


def _worst_ulp(got, want):
    return max((ulp_distance(got[k], want[k]) for k in got
                if got[k].numel()), default=0)




@pytest.mark.parametrize("case", list(B12_CASES))
@pytest.mark.parametrize("slot", [False, True], ids=["B1", "B2"])
def test_b1_b2_cases_match_plain_twice_bitwise(case, slot):
    """The plain version to 0 ulp (fp32 y', m') or 1 ulp (bf16 y'), one
    launch per group, two launches bitwise equal, and a plan with no
    block without work."""
    sizes, dtype, corr_dtype, views = B12_CASES[case]
    dtype = getattr(torch, dtype)
    y, g, c, m = _leaf_trees(sizes, dtype, len(sizes), views,
                             getattr(torch, corr_dtype))
    name = "scaffold_momentum_update" if slot else "scaffold_update"
    runs = []
    for _ in range(2):
        before = ops.LAUNCHES[name]
        if slot:
            runs.append(ops.scaffold_momentum_update_packed(y, g, c, m, 0.3,
                                                            0.9))
        else:
            runs.append((ops.scaffold_update_packed(y, g, c, 0.3), {}))
        assert ops.LAUNCHES[name] == before + 1
    for (y1, m1), (y2, m2) in zip(runs[:1], runs[1:]):
        assert all(torch.equal(y1[k], y2[k]) for k in y)
        assert all(torch.equal(m1[k], m2[k]) for k in m1)
    if slot:
        want_y, want_m = ref.scaffold_momentum_update_tree_ref(y, g, c, m,
                                                               0.3, 0.9)
        assert _worst_ulp(runs[0][1], want_m) == 0
    else:
        want_y = {k: ref.scaffold_update_ref(y[k], g[k], c[k], 0.3)
                  for k in y}
    assert _worst_ulp(runs[0][0], want_y) <= (dtype == torch.bfloat16)
    (plan,) = ops.plans(y, g, c, m if slot else None)
    assert 1 <= plan.grid <= plan.first[-1]
    assert plan.first[-1] == sum(-(-n // ops.CHUNK) for n in sizes)


def test_b1_on_a_mixed_hymba_layer_launches_once_a_dtype_group():
    """One hymba layer's leaves in a bf16 model (the reduced widths): the
    weights bf16, the SSD's a_log, dt_bias and d_skip fp32; B1 launches
    once for each of the two groups, each leaf within 1 ulp of the plain
    version."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(25)
    y = T._init_layer(get_reduced("hymba-1.5b"), gen, "Y", torch.bfloat16,
                      torch.device("cuda"))
    assert {k for k, v in y.items() if v.dtype == torch.float32} == {
        "mamba/a_log", "mamba/dt_bias", "mamba/d_skip"}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
         for k, v in y.items()}
    corr = {k: (0.1 * torch.randn(v.shape, generator=gen, device="cuda")).to(
        v.dtype) for k, v in y.items()}
    assert len(ops.dtype_groups(y, g, corr)) == 2
    before = ops.LAUNCHES["scaffold_update"]
    out = ops.scaffold_update_packed(y, g, corr, 0.05)
    assert ops.LAUNCHES["scaffold_update"] == before + 2
    for k in y:
        assert out[k].dtype == y[k].dtype, k
        assert ulp_distance(out[k], ref.scaffold_update_ref(
            y[k], g[k], corr[k], 0.05)) <= 1, k


def test_b1_refuses_a_group_of_257_leaves():
    y, g, c, _ = _leaf_trees([3] * 257, torch.float32, 257)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="257 leaves"):
        ops.scaffold_update_packed(y, g, c, 0.1)
    assert ops.LAUNCHES == before


def test_b1_group_of_empty_leaves_launches_nothing():
    y, g, c, _ = _leaf_trees([0, 0], torch.float32, 2)
    before = dict(ops.LAUNCHES)
    out = ops.scaffold_update_packed(y, g, c, 0.1)
    assert ops.LAUNCHES == before and out["l0"].shape == (0,)


def test_launch_floor_runs_on_every_table():
    for n_leaves in (1, 4, 5, 16, 17, 64, 65, 256):
        plan = ops.update_plan([ops.CHUNK] * n_leaves, 132)
        for momentum in (False, True):
            ops.launch_floor(plan, momentum=momentum)
    torch.cuda.synchronize()


def _lora_tree(gen, layers=3, dims=((256, 256), (256, 64), (256, 64),
                                    (256, 256), (256, 512), (256, 512),
                                    (512, 256)), rank=8):
    """A LoRA delta tree as the trainer stacks it: 7 targets x A/B, A
    (layers, in, r) and B (layers, r, out), fp32."""
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    tree = {}
    for name, (d_in, d_out) in zip(names, dims):
        path = f"layers.0.{'mlp' if name.startswith('w_') else 'attn'}.{name}"
        tree[f"{path}/A"] = torch.randn(layers, d_in, rank, generator=gen,
                                        device="cuda")
        tree[f"{path}/B"] = torch.randn(layers, rank, d_out, generator=gen,
                                        device="cuda")
    return tree


@pytest.mark.parametrize("slot", [False, True], ids=["B1", "B2"])
def test_b1_b2_on_a_lora_delta_tree(slot):
    """One launch for the 14 stacked factors, within the ulp bounds."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    y, g, c = (_lora_tree(gen) for _ in range(3))
    m = ({k: torch.randn(v.shape, generator=gen, device="cuda")
          for k, v in y.items()} if slot else None)
    name = "scaffold_momentum_update" if slot else "scaffold_update"
    before = ops.LAUNCHES[name]
    if slot:
        oy, om = ops.scaffold_momentum_update_packed(y, g, c, m, 0.01, 0.9)
    else:
        oy = ops.scaffold_update_packed(y, g, c, 0.01)
    assert ops.LAUNCHES[name] == before + 1
    for k in y:
        if slot:
            py, pm = ref.scaffold_momentum_update_ref(y[k], g[k], c[k], m[k],
                                                      0.01, 0.9)
            assert ulp_distance(om[k], pm) == 0, k
        else:
            py = ref.scaffold_update_ref(y[k], g[k], c[k], 0.01)
        assert ulp_distance(oy[k], py) <= 1, k


def test_bf16_checkpoint_round_trips_on_the_card(tmp_path):
    """bf16 leaves on the card are written as raw 2-byte words and read
    back bitwise, onto the card."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device="cuda").manual_seed(22)
    tree = {"x": {"embed": torch.randn(64, 32, generator=gen,
                                       device="cuda").bfloat16(),
                  "layers.0.attn.wq/A": torch.randn(2, 32, 4, generator=gen,
                                                    device="cuda")},
            "t": torch.tensor(3, dtype=torch.int32, device="cuda")}
    save_checkpoint(str(tmp_path / "ck"), tree, extra={"round": 2})
    back, extra = load_checkpoint(str(tmp_path / "ck"), tree)
    assert extra == {"round": 2}
    for k in ("embed", "layers.0.attn.wq/A"):
        a, b = back["x"][k], tree["x"][k]
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
    assert int(back["t"]) == 3


# the scanned engine: each round one replay of a captured CUDA graph


def _scan_quads():
    from repro_torch.data import make_similarity_quadratics

    return make_similarity_quadratics(10, 64, delta=0.3, G=4.0, mu=0.3,
                                      seed=1)


def _scan_case(case):
    """(spec, dataset, loss_fn, init) of a captured-round check."""
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.data import EmnistLikeFederated, quadratic_loss
    from repro_torch.models import simple

    if case.startswith("mlp"):
        data = EmnistLikeFederated(10, 2000, 10.0, seed=0, test_samples=100)
        spec = FedRoundSpec(
            algorithm="scaffold", num_clients=10, num_sampled=4,
            local_steps=5, local_batch=data.local_batch_size(0.2),
            eta_l=0.3, **({"local_solver": "momentum"}
                          if case == "mlp heavy-ball" else {}))
        return spec, data, simple.mlp_loss, lambda gen: simple.mlp_init(
            gen, 784, 62, device=gen.device)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=10, num_sampled=3,
                        local_steps=4, local_batch=1, eta_l=0.05,
                        use_megakernel=case == "quadratics B3")
    ds = _scan_quads()
    return spec, ds, quadratic_loss, lambda gen: {"x": torch.ones(ds.dim)}


@pytest.mark.parametrize("case", ["quadratics B1", "quadratics B3", "mlp",
                                  "mlp heavy-ball"])
def test_captured_rounds_equal_the_eager_host_loop(case):
    """A scanned trainer on the card (a warm-up round, then each round a
    replay of its captured graph) equals the eager per-round host loop on
    the same device streams bitwise: x, c and every store row."""
    from chip_smoke import host_loop_device_rng, scanned_vs_host_loop
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case(case)
    tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                          use_fused_update=True, device="cuda",
                          scan_rounds=2)
    assert tr.scan_captured and tr.scan_graph_reason is None
    tr.run(4)
    assert tr._graph is not None
    server, rows, hist = host_loop_device_rng(spec, ds, 4, loss_fn, init)
    cmp = scanned_vs_host_loop(tr, server, rows)
    assert cmp["apart"] == 0, cmp
    assert [h["loss"] for h in tr.history] == [h["loss"] for h in hist]


@pytest.mark.parametrize("case,key,per_round", [
    ("quadratics B1", "scaffold_update", 3 * 4),
    ("quadratics B3", "scaffold_local_loop", 3),
    ("mlp heavy-ball", "scaffold_momentum_update", 4 * 5),
])
def test_launch_counts_follow_graph_replays(case, key, per_round):
    """After the warm-up round, 3 rounds (a capture and its replay, then
    two replays) count 3 x the round's launches: the graph's tally is
    added at each replay."""
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case(case)
    tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                          use_fused_update=True, device="cuda",
                          scan_rounds=3)
    tr.run_round()
    assert tr._graph is None
    ops.reset_launches()
    mk.reset_plans()
    tr.run(3)
    assert tr._tally.launches()[key] == per_round
    assert ops.LAUNCHES[key] == 3 * per_round
    assert sum(ops.LAUNCHES.values()) == 3 * per_round
    if key in mk.PLANS:
        assert sum(mk.PLANS[key].values()) == 3 * per_round


def test_privatized_scanned_rounds_run_uncaptured_on_the_card():
    """The exact clip reads the norm on the host: its scanned rounds run
    eagerly on the card with the reason given, equal to the host loop."""
    import dataclasses

    from chip_smoke import host_loop_device_rng, scanned_vs_host_loop
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case("quadratics B1")
    spec = dataclasses.replace(spec, privatizer="server_gauss",
                               clip_norm=0.5, noise_multiplier=1.1)
    tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                          use_fused_update=True, device="cuda",
                          scan_rounds=2)
    assert not tr.scan_captured
    assert tr.scan_graph_reason == ("privatizer 'server_gauss': its exact "
                                    "clip reads the norm on the host")
    tr.run(3)
    assert tr._graph is None
    server, rows, _ = host_loop_device_rng(spec, ds, 3, loss_fn, init)
    assert scanned_vs_host_loop(tr, server, rows)["apart"] == 0


def test_gemma_w_layers_capture_b5():
    """The reduced gemma3 (fp32, "WF") at seq 128: B5 runs on the band
    path inside the captured round, counted at each replay, and the
    scanned run equals the eager host loop within 1e-4 of each leaf."""
    from functools import partial

    from chip_smoke import host_loop_device_rng, scanned_vs_host_loop
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    cfg = get_reduced("gemma3-1b")
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.01)
    data = SyntheticLMFederated(4, cfg.vocab_size, 128)
    loss_fn = partial(M.loss_fn, cfg)
    init = partial(M.init_params, cfg, device="cuda")
    tr = FederatedTrainer(loss_fn, init, spec, data, seed=0,
                          use_fused_update=True, device="cuda",
                          scan_rounds=2)
    tr.run_round()
    swa_ops.reset_launches()
    tr.run(2)
    assert tr._tally.launches()["swa_attention"] == 4
    assert swa_ops.LAUNCHES["swa_attention"] == 2 * 4
    server, rows, _ = host_loop_device_rng(spec, data, 3, loss_fn, init)
    assert scanned_vs_host_loop(tr, server, rows)["max_rel"] <= 1e-4


# the tiered store's scanned engine: a cohort buffer on the card, the
# population in host stores


def _trainer_state(tr):
    """x, c, the optimizer's slots and every population row, on the host
    (the dense engine's device store mirrored, the tiered one flushed)."""
    tr.sync_host_store()
    out = {f"x/{k}": v.cpu() for k, v in tr.x.items()}
    out.update({f"c/{k}": v.cpu() for k, v in tr.c.items()})
    for name, st in tr._store_families():
        out.update({f"{name}/{k}": v for k, v in st.all_rows().items()})
    return out


@pytest.mark.parametrize("case", ["quadratics B1", "quadratics B3"])
def test_captured_tiered_rounds_equal_the_dense_engine(case):
    """The tiered scanned engine on the card (the cohort buffer, the
    round's ids read at the slot, each round a replay of its graph)
    equals the dense scanned engine bitwise, launches and all."""
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case(case)
    runs = {}
    for store in ("dense", "tiered"):
        tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                              use_fused_update=True, device="cuda",
                              scan_rounds=2, store=store)
        assert tr.scan_captured
        ops.reset_launches()
        tr.run(6)
        assert tr._graph is not None
        runs[store] = (_trainer_state(tr), [m["loss"] for m in tr.history],
                       dict(ops.LAUNCHES))
        tr.close()
    (a, la, na), (b, lb, nb) = runs["dense"], runs["tiered"]
    assert la == lb and na == nb and sum(na.values()) > 0
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_tiered_repairs_a_client_resampled_across_chunks(monkeypatch):
    """N 10, S 3, chunks of 2: consecutive chunks share clients, whose
    prefetched rows the previous chunk's write-back (a copy from the card
    the worker waits on) made stale; ``take`` reads them again, and the
    run equals the dense engine bitwise."""
    import numpy as np

    from repro_torch.core import FederatedTrainer
    from repro_torch.core import store as tstore

    repaired = []
    real = tstore.refresh_rows

    def counting(prefetched, fresh, stale):
        repaired.append(int(stale.sum()))
        real(prefetched, fresh, stale)

    monkeypatch.setattr(tstore, "refresh_rows", counting)
    spec, ds, loss_fn, init = _scan_case("quadratics B1")
    states = []
    for store in ("dense", "tiered"):
        tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                              use_fused_update=True, device="cuda",
                              scan_rounds=2, store=store, prefetch_depth=3)
        tr.run(12)
        states.append(_trainer_state(tr))
        if store == "tiered":
            plans = [tr._plan_chunk(t, 2) for t in range(2, 12, 2)]
        tr.close()
    shared = sum(len(np.intersect1d(a.union, b.union))
                 for a, b in zip(plans, plans[1:]))
    assert shared > 0 and sum(repaired) > 0
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


# the async buffered engine on the card


@pytest.mark.parametrize("case,key", [
    ("mlp", "scaffold_update"), ("mlp heavy-ball", "scaffold_momentum_update"),
    ("quadratics B3", "scaffold_local_loop")])
def test_async_degenerate_limit_equals_the_sync_loop(case, key):
    """M = K = S, always_on, constant: the async engine's aggregations are
    the synchronous rounds bit for bit on the card, with the same
    launches of the case's kernel."""
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case(case)
    runs = {}
    for name, kw in (("sync", {}), ("async", dict(
            async_buffer=spec.num_sampled,
            max_inflight=spec.num_sampled))):
        tr = FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                              use_fused_update=True, device="cuda", **kw)
        ops.reset_launches()
        for _ in range(3):
            tr.run_round()
        runs[name] = (_trainer_state(tr),
                      [{k: m[k] for k in ("loss", "drift", "update_norm",
                                          "bytes_up", "round")}
                       for m in tr.history], dict(ops.LAUNCHES))
        tr.close()
    (a, ha, na), (b, hb, nb) = runs["sync"], runs["async"]
    assert ha == hb and na == nb and na[key] > 0
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_async_stragglers_tiered_and_resume_on_the_card(tmp_path):
    """Lognormal stragglers with dropout, M 2 of K 4, polynomial
    weighting, int8_ef on the MLP: the tiered store equals the dense one
    bitwise, and a checkpoint with updates in flight and buffered resumes
    bitwise."""
    import dataclasses

    from repro_torch.checkpoint import load_trainer, save_trainer
    from repro_torch.core import FederatedTrainer

    spec, ds, loss_fn, init = _scan_case("mlp")
    spec = dataclasses.replace(spec, compress="int8_ef")
    kw = dict(async_buffer=2, max_inflight=4, availability="lognormal",
              availability_kwargs=dict(seed=1, sigma=1.5, dropout=0.2),
              staleness_weighting="polynomial")

    def trainer(**extra):
        return FederatedTrainer(loss_fn, init, spec, ds, seed=0,
                                use_fused_update=True, device="cuda",
                                **kw, **extra)

    dense, tiered = trainer(), trainer(store="tiered")
    for _ in range(6):
        assert dense.run_round() == tiered.run_round()
    a, b = _trainer_state(dense), _trainer_state(tiered)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    tiered.close()
    part = trainer()
    for _ in range(3):
        part.run_round()
    while not part.async_engine._buffer:
        part.async_engine.step()
    assert part.async_engine._inflight
    save_trainer(str(tmp_path / "ck"), part)
    resumed = trainer()
    load_trainer(str(tmp_path / "ck.npz"), resumed)
    for _ in range(3):
        resumed.run_round()
    assert resumed.history == dense.history[3:]
    c = _trainer_state(resumed)
    for k in a:
        assert torch.equal(a[k], c[k]), k


def _g1_operands(m, k, n, ends, gen):
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((len(ends), k, n), generator=gen, device="cuda")
    return a, b, torch.tensor(ends, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("case", range(len(G1_CASES)))
def test_grouped_mm_matches_plain(case):
    """G1's forward and both gradients (through ``grouped_mm``'s
    autograd) against the plain version's autograd, fp32, within
    G1_BOUND of each result's largest element; an empty group's weight
    gradient is zero; 3 launches (forward, input and weight gradient)."""
    from repro_torch.kernels.grouped_mm import (
        LAUNCHES,
        grouped_mm,
        reset_launches,
    )
    from repro_torch.kernels.grouped_mm import ref as gmm_ref

    m, k, n, ends = G1_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(case)
    a, b, e = _g1_operands(m, k, n, ends, gen)
    d = torch.randn((m, n), generator=gen, device="cuda")
    got, want = [], []
    for fn, out in ((grouped_mm, got), (gmm_ref.grouped_mm_ref, want)):
        aa, bb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        reset_launches()
        y = fn(aa, bb, e)
        y.backward(d)
        out.append((y.detach(), aa.grad, bb.grad, dict(LAUNCHES)))
    for x, w in zip(got[0][:3], want[0][:3]):
        assert float((x - w).abs().max() / w.abs().max()) <= G1_BOUND
    assert got[0][3] == {"grouped_mm": 3} and want[0][3] == {"grouped_mm": 0}
    lo = (0,) + tuple(ends[:-1])
    for g, (i, j) in enumerate(zip(lo, ends)):
        if i == j:
            assert not bool(got[0][2][g].any())


def test_grouped_mm_bf16_takes_the_library_product():
    """bf16 on the card is ``torch._grouped_mm`` (no launch of G1), within
    bf16 rounding of the fp32 plain version; no host sync either way."""
    from repro_torch.kernels.grouped_mm import (
        LAUNCHES,
        grouped_mm,
        reset_launches,
    )
    from repro_torch.kernels.grouped_mm import ref as gmm_ref

    a, b, e = _g1_operands(128, 256, 128, (40, 64, 64, 128),
                           torch.Generator(device="cuda").manual_seed(7))
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grouped_mm(a.bfloat16(), b.bfloat16(), e)
        grouped_mm(a, b, e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES["grouped_mm"] == 1 and got.dtype == torch.bfloat16
    want = gmm_ref.grouped_mm_ref(a.bfloat16().float(), b.bfloat16().float(),
                                  e)
    assert float((got.float() - want).abs().max() / want.abs().max()) < 1e-2


def test_moe_decode_step_makes_no_host_sync():
    """The reduced qwen2-moe's ragged decode step (fp32: G1) on the card
    under ``set_sync_debug_mode("error")``, equal to the CPU's within
    1e-4."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_reduced("qwen2-moe-a2.7b"),
                              moe_impl="ragged")
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        params = {k: v.to(dev) for k, v in p.items()}
        cache = M.init_cache(cfg, 2, 4, device=dev)
        pos = torch.zeros(2, dtype=torch.int32, device=dev)
        tokens = tok.to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                outs[dev] = M.decode_step(cfg, params, cache, tokens, pos)[0]
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    assert float((outs["cuda"].cpu() - outs["cpu"]).abs().max()) <= 1e-4


def _moe_trainer(dtype, device, **kw):
    """The reduced qwen2-moe under the ragged dispatch in ``dtype``, a
    SCAFFOLD trainer of 4 clients, 2 a round, 2 local steps."""
    import dataclasses
    from functools import partial

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedRoundSpec
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import SyntheticLMFederated
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_reduced("qwen2-moe-a2.7b"),
                              moe_impl="ragged", param_dtype=dtype,
                              compute_dtype=dtype)
    spec = FedRoundSpec(algorithm="scaffold", num_clients=4, num_sampled=2,
                        local_steps=2, local_batch=1, eta_l=0.05)
    return FederatedTrainer(
        partial(M.loss_fn, cfg), partial(M.init_params, cfg, device=device),
        spec, SyntheticLMFederated(4, cfg.vocab_size, 32), seed=0,
        use_fused_update=True, device=device, **kw)


def moe_rounds_apart(dtype, device, path):
    """3 rounds of ``_moe_trainer``, then again: a second run, a trainer
    resumed from the second's checkpoint at round 2, the pipelined
    engine and the tiered store. Returns, for each of these, the state
    leaves (x, c, every store row) and round losses that differ from the
    first run's bitwise."""
    from repro_torch.checkpoint import load_trainer, save_trainer

    def run(tr, rounds=3):
        for _ in range(rounds):
            tr.run_round()
        return tr

    def apart(tr, want, losses):
        got = _trainer_state(tr)
        out = sorted(k for k in want if not torch.equal(want[k], got[k]))
        if [h["loss"] for h in tr.history] != losses:
            out.append("loss")
        tr.close()
        return out

    first = run(_moe_trainer(dtype, device))
    want, losses = _trainer_state(first), [h["loss"] for h in first.history]
    first.close()
    second = run(_moe_trainer(dtype, device), 2)
    save_trainer(path, second)
    resumed = _moe_trainer(dtype, device)
    load_trainer(path + ".npz", resumed)
    return {"again": apart(run(second, 1), want, losses),
            "resumed": apart(run(resumed, 1), want, losses[2:]),
            "pipelined": apart(run(_moe_trainer(dtype, device,
                                                pipeline_depth=1)),
                               want, losses),
            "tiered": apart(run(_moe_trainer(dtype, device,
                                             store="tiered")),
                            want, losses)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_rounds_repeat_bitwise(dtype, tmp_path):
    """The reduced qwen2-moe's ragged rounds on the card (fp32 through
    G1, bf16 through ``torch._grouped_mm``; the combine in a fixed
    order; the backward through the sort's gathers) repeat bitwise: a
    second run, a resumed one, the pipelined engine and the tiered store
    each equal the first run in x, c, every store row and every loss."""
    apart = moe_rounds_apart(dtype, "cuda", str(tmp_path / "ck"))
    assert apart == {k: [] for k in apart}, apart
