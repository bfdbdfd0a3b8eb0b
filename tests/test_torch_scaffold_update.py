"""The port's fused corrected-step update (kernel B1) against the JAX
package's Pallas kernel.

The JAX side runs ``scaffold_update_packed`` under ``force_interpret()``,
i.e. the Pallas kernel body in interpret mode on the CPU; the port runs
its plain version (what its wrapper does for CPU tensors). Both get the
same numpy inputs. Bound: 1 ulp of the output dtype at the operands'
scale |y| + |eta*(g + corr)| (XLA may contract the multiply into an FMA
where the port rounds it; under cancellation that one rounding is many
ulps of the small result). The port's own paths agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scaffold_update.ops import (
    count_pallas_calls,
    force_interpret,
)
from repro.kernels.scaffold_update.ops import (
    scaffold_update_packed as jax_packed,
)
from repro_torch.kernels.scaffold_update import ops, ref

ETA = 0.05
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def within_one_ulp(out, ref_out, y, g, c) -> bool:
    """|out - ref_out| <= 1 ulp (of out's dtype) of |y| + |eta*(g + c)|."""
    p = {torch.float32: 24, torch.bfloat16: 8}[out.dtype]
    scale = (y.double().abs() + ETA * (g.double() + c.double()).abs())
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - p)
    return bool(((out.double() - ref_out.double()).abs() <= ulp).all())


def _from_jax(a, dtype) -> torch.Tensor:
    """A JAX array -> torch in ``dtype`` (exact: via fp32)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tree(rng, spec):
    """numpy fp32 draws for leaves {name: (y, g, corr dtypes, shape)}."""
    return {k: [rng.standard_normal(shape).astype(np.float32)
                for _ in range(3)] for k, (*_, shape) in spec.items()}


def _run_both(spec, draws):
    jy = {k: jnp.asarray(draws[k][0], JNP[spec[k][0]]) for k in spec}
    jg = {k: jnp.asarray(draws[k][1], JNP[spec[k][1]]) for k in spec}
    jc = {k: jnp.asarray(draws[k][2], JNP[spec[k][2]]) for k in spec}
    ty = {k: torch.from_numpy(draws[k][0]).to(TORCH[spec[k][0]])
          for k in spec}
    tg = {k: torch.from_numpy(draws[k][1]).to(TORCH[spec[k][1]])
          for k in spec}
    tc = {k: torch.from_numpy(draws[k][2]).to(TORCH[spec[k][2]])
          for k in spec}
    with force_interpret():
        jout = jax_packed(jy, jg, jc, ETA)
        n_calls = count_pallas_calls(lambda a, b, c: jax_packed(a, b, c, ETA),
                                     jy, jg, jc)
    tout = ops.scaffold_update_packed(ty, tg, tc, ETA, device="cpu")
    return jout, tout, n_calls, (ty, tg, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (77,), (4099,), (3, 257, 5)])
def test_packed_matches_pallas_interpret(dtype, shape):
    spec = {"w": (dtype, dtype, dtype, shape)}
    draws = _tree(np.random.default_rng(0), spec)
    jout, tout, n_calls, (ty, tg, tc) = _run_both(spec, draws)
    assert n_calls == 1
    assert tout["w"].dtype == TORCH[dtype] and tout["w"].shape == shape
    assert within_one_ulp(tout["w"], _from_jax(jout["w"], TORCH[dtype]),
                          ty["w"], tg["w"], tc["w"])


def test_mixed_dtype_tree_groups_and_values():
    spec = {"a": ("bfloat16", "bfloat16", "bfloat16", (4099,)),
            "b": ("float32", "bfloat16", "float32", (77,)),
            "c": ("float32", "float32", "float32", (33, 7)),
            "d": ("bfloat16", "bfloat16", "bfloat16", (9,)),
            "e": ("float32", "bfloat16", "float32", (2, 300))}
    draws = _tree(np.random.default_rng(1), spec)
    jout, tout, n_calls, (ty, tg, tc) = _run_both(spec, draws)
    groups = ops.dtype_groups(ty, tg, tc)
    # the port launches once per group, exactly as many as pallas_calls
    assert len(groups) == n_calls == 3
    assert sorted(map(sorted, groups.values())) == [["a", "d"], ["b", "e"],
                                                    ["c"]]
    for k in spec:
        dt = TORCH[spec[k][0]]
        assert tout[k].dtype == dt
        assert within_one_ulp(tout[k], _from_jax(jout[k], dt), ty[k], tg[k],
                              tc[k])
        # every leaf equals the per-leaf plain version exactly
        assert torch.equal(tout[k], ref.scaffold_update_ref(
            ty[k], tg[k], tc[k], ETA))


def test_in_place_out_matches_fresh():
    rng = np.random.default_rng(2)
    y, g, c = ({"w": torch.from_numpy(rng.standard_normal(1000)
                                      .astype(np.float32))} for _ in range(3))
    before = ops.LAUNCHES["scaffold_update"]
    fresh = ops.scaffold_update_packed(y, g, c, ETA, device="cpu")
    work = {"w": y["w"].clone()}
    ops.scaffold_update_packed(work, g, c, ETA, out=work, device="cpu")
    assert torch.equal(work["w"], fresh["w"])
    assert ops.LAUNCHES["scaffold_update"] == before  # no kernel on the CPU

