"""The port's fused heavy-ball step (kernel B2) against the JAX package's
Pallas kernel.

The JAX side runs ``scaffold_momentum_update`` and
``scaffold_momentum_update_packed`` with ``interpret=True`` (the Pallas
kernel body on the CPU); the port runs its plain version, which is what
its wrapper does for CPU tensors. Same numpy inputs, y and g and corr in
fp32 or bf16, the slot m in fp32. XLA on the CPU contracts both products
into FMAs (``fma(beta, m, g + corr)``, ``fma(-eta, m', y)``) where the
port rounds each product. The bound is what each of those roundings can
move a result by: m' within 1 ulp of fp32 at its operands' scale
``|beta*m| + |g + corr|``; y' within 1 ulp of its dtype at
``|y| + eta*(|beta*m| + |g + corr|)`` (both final roundings), plus half
an fp32 ulp of the product ``eta*m'`` the port rounds, plus
``eta*|m'_port - m'_jax|``. In fp32 y' is then at most 2 ulps from the
reference's. The port's own paths agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scaffold_update.ops import count_pallas_calls
from repro.kernels.scaffold_update.ops import (
    scaffold_momentum_update as jax_leaf,
)
from repro.kernels.scaffold_update.ops import (
    scaffold_momentum_update_packed as jax_packed,
)
from repro_torch.kernels.scaffold_update import ops, ref

ETA, BETA = 0.05, 0.9
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ulp(scale: torch.Tensor, dtype) -> torch.Tensor:
    p = {torch.float32: 24, torch.bfloat16: 8}[dtype]
    _, e = torch.frexp(scale)
    return torch.ldexp(torch.ones_like(scale), e - p)


def within_bound(y_out, m_out, y_ref, m_ref, y, g, c, m) -> bool:
    """The module docstring's bound on m' and y'."""
    scale_m = BETA * m.double().abs() + (g.double() + c.double()).abs()
    scale_y = y.double().abs() + ETA * scale_m
    dm = (m_out.double() - m_ref.double()).abs()
    dy = (y_out.double() - y_ref.double()).abs()
    ok_m = dm <= _ulp(scale_m, torch.float32)
    ok_y = dy <= (_ulp(scale_y, y_out.dtype)
                  + 0.5 * _ulp(ETA * scale_m, torch.float32) + ETA * dm)
    return bool(ok_m.all() and ok_y.all())


def _from_jax(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _draws(rng, spec):
    """numpy fp32 draws of y, g, corr, m for leaves {name: (dtype of y, g,
    corr, shape)}."""
    return {k: [rng.standard_normal(shape).astype(np.float32)
                for _ in range(4)] for k, (*_, shape) in spec.items()}


def _trees(spec, draws):
    """(jax trees, torch trees) of y, g, corr (in their dtypes) and m
    (fp32)."""
    jt = [{k: jnp.asarray(draws[k][i], JNP[spec[k][i]]) for k in spec}
          for i in range(3)]
    tt = [{k: torch.from_numpy(draws[k][i]).to(TORCH[spec[k][i]])
           for k in spec} for i in range(3)]
    jt.append({k: jnp.asarray(draws[k][3]) for k in spec})
    tt.append({k: torch.from_numpy(draws[k][3]) for k in spec})
    return jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (77,), (4099,), (3, 257, 5)])
def test_leaf_matches_pallas_interpret(dtype, shape):
    spec = {"w": (dtype, dtype, dtype, shape)}
    (jy, jg, jc, jm), (ty, tg, tc, tm) = _trees(
        spec, _draws(np.random.default_rng(0), spec))
    yj, mj = jax_leaf(jy["w"], jg["w"], jc["w"], jm["w"], ETA, BETA,
                      interpret=True)
    before = dict(ops.LAUNCHES)
    yt, mt = ops.scaffold_momentum_update(ty["w"], tg["w"], tc["w"],
                                          tm["w"], ETA, BETA, device="cpu")
    assert ops.LAUNCHES == before  # the plain version on the CPU
    assert yt.dtype == TORCH[dtype] and mt.dtype == torch.float32
    assert yt.shape == mt.shape == shape
    assert within_bound(yt, mt, _from_jax(yj, yt.dtype),
                          _from_jax(mj, torch.float32), ty["w"], tg["w"],
                          tc["w"], tm["w"])


def test_mixed_dtype_tree_groups_values_and_in_place():
    spec = {"a": ("bfloat16", "bfloat16", "bfloat16", (4099,)),
            "b": ("float32", "bfloat16", "float32", (77,)),
            "c": ("float32", "float32", "float32", (33, 7)),
            "d": ("bfloat16", "bfloat16", "bfloat16", (9,)),
            "e": ("float32", "bfloat16", "float32", (2, 300))}
    (jy, jg, jc, jm), (ty, tg, tc, tm) = _trees(
        spec, _draws(np.random.default_rng(1), spec))
    yj, mj = jax_packed(jy, jg, jc, jm, ETA, BETA, interpret=True)
    n_calls = count_pallas_calls(
        lambda a, b, c, d: jax_packed(a, b, c, d, ETA, BETA, interpret=True),
        jy, jg, jc, jm)
    yt, mt = ops.scaffold_momentum_update_packed(ty, tg, tc, tm, ETA, BETA,
                                                 device="cpu")
    groups = ops.dtype_groups(ty, tg, tc, tm)
    # one launch per (y, g, corr, m) group, as many as the pallas_calls
    assert len(groups) == n_calls == 3
    assert sorted(map(sorted, groups.values())) == [["a", "d"], ["b", "e"],
                                                    ["c"]]
    y_plain, m_plain = ref.scaffold_momentum_update_tree_ref(ty, tg, tc, tm,
                                                             ETA, BETA)
    # in place into the working copy and the slot, as the solver calls it
    work_y = {k: v.clone() for k, v in ty.items()}
    work_m = {k: v.clone() for k, v in tm.items()}
    ops.scaffold_momentum_update_packed(work_y, tg, tc, work_m, ETA, BETA,
                                        out=work_y, m_out=work_m,
                                        device="cpu")
    for k in spec:
        assert yt[k].dtype == TORCH[spec[k][0]]
        assert mt[k].dtype == torch.float32
        assert within_bound(yt[k], mt[k], _from_jax(yj[k], yt[k].dtype),
                              _from_jax(mj[k], torch.float32), ty[k], tg[k],
                              tc[k], tm[k]), k
        for got_y, got_m in ((yt[k], mt[k]), (work_y[k], work_m[k])):
            assert torch.equal(got_y, y_plain[k])
            assert torch.equal(got_m, m_plain[k])
