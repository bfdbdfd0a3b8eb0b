"""The port's K-step local loops (kernels B3 and B4) against the JAX
package's Pallas megakernels.

The JAX side runs ``megakernel.scaffold_local_loop`` in interpret mode
(the Pallas body on the CPU; with a slot ``m`` that is
``scaffold_momentum_local_loop_2d``); the port runs its plain version,
which is what its wrapper does for CPU tensors and the CPU fast path of
``run_local_steps``. Same numpy inputs; y_K, m_K and the per-step losses
agree to rtol 1e-5 (fp32 sums taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scaffold_update import megakernel as jmk
from repro.kernels.scaffold_update import ref as jref
from repro.kernels.scaffold_update.ops import force_interpret
from repro_torch.kernels.scaffold_update import megakernel as mk
from repro_torch.kernels.scaffold_update import ops

RTOL = 1e-5


def _inputs(d, K, bsz, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        y=rng.standard_normal(d).astype(np.float32),
        corr=(0.1 * rng.standard_normal(d)).astype(np.float32),
        A=(rng.standard_normal((K, bsz, d, d)) / np.sqrt(d)).astype(np.float32),
        b=rng.standard_normal((K, bsz, d)).astype(np.float32),
        eta=np.linspace(0.1, 0.05, K).astype(np.float32),
    )


def _close(port, jax_out, scale=None):
    a = port.double().numpy()
    b = np.asarray(jax_out, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    return np.abs(a - b).max() <= RTOL * max(scale, 1e-30)


@pytest.mark.parametrize("d", [20, 130])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("with_corr", [True, False])
def test_local_loop_matches_pallas_interpret(d, K, with_corr):
    z = _inputs(d, K, bsz=2)
    corr_j = {"x": jnp.asarray(z["corr"])} if with_corr else None
    corr_t = {"x": torch.from_numpy(z["corr"])} if with_corr else None
    with force_interpret():
        yj, mj, lj = jmk.scaffold_local_loop(
            {"x": jnp.asarray(z["y"])}, corr_j,
            {"A": jnp.asarray(z["A"]), "b": jnp.asarray(z["b"])},
            jnp.asarray(z["eta"]))
    before = ops.LAUNCHES["scaffold_local_loop"]
    yt, mt, lt = mk.scaffold_local_loop(
        {"x": torch.from_numpy(z["y"])}, corr_t,
        {"A": torch.from_numpy(z["A"]), "b": torch.from_numpy(z["b"])},
        torch.from_numpy(z["eta"]), device="cpu")
    assert ops.LAUNCHES["scaffold_local_loop"] == before  # plain on the CPU
    assert mj is None and mt is None
    assert yt["x"].shape == (d,) and lt.shape == (K,)
    assert _close(yt["x"], yj["x"])
    assert _close(lt, lj)


@pytest.mark.parametrize("K", [1, 4])
def test_momentum_local_loop_matches_pallas_interpret(K):
    """B4's plain version against the Pallas heavy-ball loop at d=33 (the
    JAX side pads it to 128 lanes)."""
    z = _inputs(33, K, bsz=2, seed=3)
    m0 = np.random.default_rng(6).standard_normal(33).astype(np.float32)
    yj, mj, lj = jmk.scaffold_local_loop(
        {"x": jnp.asarray(z["y"])}, {"x": jnp.asarray(z["corr"])},
        {"A": jnp.asarray(z["A"]), "b": jnp.asarray(z["b"])},
        jnp.asarray(z["eta"]), m={"x": jnp.asarray(m0)}, beta=0.9,
        interpret=True)
    before = dict(ops.LAUNCHES)
    yt, mt, lt = mk.scaffold_local_loop(
        {"x": torch.from_numpy(z["y"])}, {"x": torch.from_numpy(z["corr"])},
        {"A": torch.from_numpy(z["A"]), "b": torch.from_numpy(z["b"])},
        torch.from_numpy(z["eta"]), m={"x": torch.from_numpy(m0)}, beta=0.9,
        device="cpu")
    assert ops.LAUNCHES == before  # plain on the CPU
    assert yt["x"].shape == mt["x"].shape == (33,) and lt.shape == (K,)
    assert mt["x"].dtype == torch.float32
    assert (_close(yt["x"], yj["x"]) and _close(mt["x"], mj["x"])
            and _close(lt, lj))


@pytest.mark.parametrize("K", [1, 4])
def test_momentum_branch_matches_reference_plain(K):
    """The heavy-ball branch of the plain version (the CPU path of kernel
    B4) against the JAX plain version."""
    z = _inputs(33, K, bsz=2, seed=1)
    m0 = np.random.default_rng(5).standard_normal(33).astype(np.float32)
    yj, mj, lj = jref.scaffold_local_loop_ref(
        jnp.asarray(z["y"]), jnp.asarray(z["corr"]), jnp.asarray(z["eta"]),
        jnp.asarray(z["A"]), jnp.asarray(z["b"]), m=jnp.asarray(m0),
        beta=0.9)
    yt, mt, lt = mk.scaffold_local_loop(
        {"x": torch.from_numpy(z["y"])}, {"x": torch.from_numpy(z["corr"])},
        {"A": torch.from_numpy(z["A"]), "b": torch.from_numpy(z["b"])},
        torch.from_numpy(z["eta"]), m={"x": torch.from_numpy(m0)}, beta=0.9,
        device="cpu")
    assert _close(yt["x"], yj) and _close(mt["x"], mj) and _close(lt, lj)


def test_broadcast_batches_match_materialised():
    """The trainer hands the kernel broadcast (stride-0) K/bsz views; the
    plain version gives the same result on them as on a dense copy."""
    z = _inputs(16, 1, bsz=1, seed=2)
    A = torch.from_numpy(z["A"][0, 0])[None, None].expand(5, 2, 16, 16)
    b = torch.from_numpy(z["b"][0, 0])[None, None].expand(5, 2, 16)
    eta = torch.full((5,), 0.1)
    y = {"x": torch.from_numpy(z["y"])}
    ya, _, la = mk.scaffold_local_loop(y, None, {"A": A, "b": b}, eta,
                                       device="cpu")
    yb, _, lb = mk.scaffold_local_loop(
        y, None, {"A": A.contiguous(), "b": b.contiguous()}, eta,
        device="cpu")
    assert torch.equal(ya["x"], yb["x"]) and torch.equal(la, lb)

