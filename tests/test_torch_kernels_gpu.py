"""The port's CUDA kernels on the card, against their plain versions.

These run only where ``torch.cuda.is_available()`` (marker ``gpu``) and
import nothing of JAX, so they run on a GPU machine without it:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Bounds: the fused corrected and heavy-ball updates (B1, B2) within 1 ulp
of y's dtype and 0 ulp of the fp32 slot (they round each operation as
the plain versions do); the K-step loops (B3, B4) in fp32 to rtol 1e-5
(sums in another order).
"""
import math

import pytest
import torch

from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ops, ref

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU"),
]


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
