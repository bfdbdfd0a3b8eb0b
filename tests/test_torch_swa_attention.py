"""The port's sliding-window attention (B5's plain version, the op of
``"W"`` layers, the banded model layer and dense sliding attention)
against the JAX package's, on the CPU.

Inputs are numpy draws from a seed, handed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its body on the CPU) and
the reference's ``local_attention_jnp`` / ``dense_attention``.

Bounds: fp32 outputs to 2e-5 absolute (the JAX package's own kernel
bound, ``tests/test_kernels.py``); bf16 outputs to 1 bf16 ulp of the
reference's element plus 2e-5 (both round an fp32 result once; the two
fp32 results differ by the order of their sums, ~1e-6, which is more
than an ulp only for elements below 2^-8); gradients to 1e-5 of each
leaf's largest element.

The bf16 kernel's numerics (the split of the fp32 probabilities into two
bf16 halves for the tensor cores) are emulated here and held to the
JAX package's reference under the card check's bf16 rule.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import ref as jax_ref
from repro.kernels.swa_attention import swa_attention as jax_swa_attention
from repro.models import layers as JL
from repro_torch.kernels.swa_attention import ops, ref
from repro_torch.models import layers as L

# (B, S, Hq, Hkv, D, window): the JAX package's kernel test shapes
CASES = [
    (1, 512, 2, 1, 64, 128),
    (2, 256, 4, 4, 32, 64),
    (1, 384, 6, 3, 64, 128),
    (2, 128, 2, 1, 128, 64),
]
FP32_ATOL = 2e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as torch tensors and JAX arrays of ``dtype`` (the
    bf16 rounding is made once, by torch, and carried across exactly)."""
    tdt, jdt = DTYPES[dtype]
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    js = [jnp.asarray(t.float().numpy(), dtype=jdt) for t in ts]
    return ts, js


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def assert_close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= FP32_ATOL, err.max()
    else:
        assert (err <= bf16_ulp(want) + FP32_ATOL).all(), (
            (err - bf16_ulp(want)).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_pallas_interpret(case, dtype):
    b, s, hq, hkv, d, w = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(b, s, hq, hkv, d, seed=s + w), dtype)
    want = jax_swa_attention(jq, jk, jv, w, interpret=True)
    got = ref.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), w).transpose(1, 2)
    assert got.dtype == q.dtype
    assert_close(got, want.astype(jnp.float32), dtype)


def test_op_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 4, 2, 32, 64))
    before = ops.LAUNCHES["swa_attention"]
    got = ops.swa_attention(q, k, v, 64)
    want = ref.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), 64).transpose(1, 2)
    assert torch.equal(got, want)
    assert ops.LAUNCHES["swa_attention"] == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,w", [(256, 64), (320, 64), (96, 64)],
                         ids=["band", "dense-ragged", "dense-short"])
def test_local_attention_matches_jax(s, w, dtype):
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, s, 4, 2, 32, seed=s), dtype)
    want = JL.local_attention_jnp(jq, jk, jv, window=w)
    got = L.local_attention(q, k, v, window=w)
    assert got.dtype == q.dtype
    assert_close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("s,w", [(64, 64), (100, 16), (128, 1)])
def test_dense_sliding_attention_matches_jax(s, w):
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, s, 4, 1, 64, seed=s), "float32")
    want = JL.dense_attention(jq, jk, jv, mask_kind="sliding", window=w)
    got = L.dense_attention(q, k, v, mask_kind="sliding", window=w)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("case", [(2, 256, 4, 2, 32, 64),
                                  (1, 256, 2, 1, 128, 128)], ids=str)
def test_op_autograd_matches_jax_vjp_of_local_attention(case):
    b, s, hq, hkv, d, w = case
    arrays = _qkv(b, s, hq, hkv, d, seed=1)
    cot = np.random.default_rng(2).standard_normal(
        (b, s, hq, d)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q, k, v: JL.local_attention_jnp(
        q, k, v, window=w), *(jnp.asarray(a) for a in arrays))
    grads_j = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out_t = ops.swa_attention(*leaves, w)
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(cot))
    assert_close(out_t.detach(), out_j, "float32")
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        assert gt.shape == gj.shape
        assert np.abs(gt.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()


def test_op_refuses_mismatched_shapes_and_the_cuda_wrapper_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 32))
    with pytest.raises(ValueError):
        ops.swa_attention(q, k[:, :32], v[:, :32], 16)  # S differs
    with pytest.raises(ValueError):
        ops.swa_attention(q, q[:, :, :3], q[:, :, :3], 16)  # 4 % 3 heads
    with pytest.raises(ValueError):
        ops.swa_attention(q, k, v, 0)
    with pytest.raises(ValueError):
        ops.swa_attention(q, k.double(), v, 16)
    with pytest.raises(ValueError, match="cpu"):
        ops.swa_attention_cuda(q, k, v, 16)


def _tensor_core_emulation(q, k, v, window: int, split: bool):
    """The bf16 kernel's arithmetic in plain PyTorch, (B, H, S, D) layout:
    bf16 q and k with exact products summed in fp32, the fp32 softmax, and
    p v on bf16 operands with fp32 sums: p as ``p_hi + p_lo``, both bf16,
    in one fp32 sum of two products (``split``), or p rounded to bf16
    alone."""
    s, d = q.shape[2], q.shape[3]
    n_rep = q.shape[1] // k.shape[1]
    k, v = (torch.repeat_interleave(t, n_rep, dim=1).float() for t in (k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    pos = torch.arange(s)
    rel = pos[:, None] - pos[None, :]
    scores = scores.masked_fill(~((rel >= 0) & (rel < window)), -math.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p_hi = p.bfloat16().float()
    if split:
        p_lo = (p - p_hi).bfloat16().float()
        o = torch.einsum("bhqk,bhkd->bhqd", torch.cat([p_hi, p_lo], -1),
                         torch.cat([v, v], 2))
    else:
        o = torch.einsum("bhqk,bhkd->bhqd", p_hi, v)
    return (o / l).bfloat16()


def _ulps_where_large(got, want):
    """max |got - want| in bf16 ulps of want over |want| >= 2^-8, and
    whether every element is within 1 ulp + 2e-5."""
    got, want = got.float().numpy(), want.float().numpy()
    err, ulp = np.abs(got - want), bf16_ulp(want)
    big = np.abs(want) >= 2.0 ** -8
    return float((err[big] / ulp[big]).max()), bool((err <= ulp + FP32_ATOL).all())


def _split_inputs(case):
    """bf16 q, k, v in (B, H, S, D) and the JAX package's reference
    output on the same values, as a torch tensor."""
    b, s, hq, hkv, d, w = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(b, s, hq, hkv, d, seed=s + w),
                                    "bfloat16")
    want = jax_ref.swa_attention_ref(*(jnp.swapaxes(t, 1, 2)
                                       for t in (jq, jk, jv)), w)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    return (*(t.transpose(1, 2) for t in (q, k, v)), want)


SPLIT_CASES = [(1, 512, 2, 1, 64, 128), (2, 256, 4, 1, 32, 64),
               (1, 256, 4, 1, 256, 128)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_probabilities_keep_the_bf16_rule(case):
    """p = p_hi + p_lo in bf16 leaves |p - p_hi - p_lo| <= 2^-18 p: the
    emulated kernel stays within 1 bf16 ulp of the JAX reference where
    |reference| >= 2^-8, and within 1 ulp + 2e-5 everywhere."""
    w = case[-1]
    q, k, v, want = _split_inputs(case)
    got = _tensor_core_emulation(q, k, v, w, split=True)
    ulps, within = _ulps_where_large(got, want)
    assert ulps <= 1 and within, ulps


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_plain_bf16_probabilities_break_the_bf16_rule(case):
    """Why the kernel splits p: rounding p to bf16 alone (the dense
    sliding path's function) lands tens of ulps off the JAX reference."""
    w = case[-1]
    q, k, v, want = _split_inputs(case)
    got = _tensor_core_emulation(q, k, v, w, split=False)
    ulps, _ = _ulps_where_large(got, want)
    assert ulps > 8, ulps
