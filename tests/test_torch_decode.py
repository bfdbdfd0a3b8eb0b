"""The port's decode against the JAX package's, on the CPU, at the
reduced configs and from the reference's weights (``params_from_jax``).

  * every decoding family at the reference test's lengths
    (``tests/test_decode_consistency.py``): llama 32, gemma3 192 (past
    its window: the ring buffer wraps), mamba2 64, hymba 128 (past its
    window of 64), minitron 32, minicpm3 32 (MLA's absorbed latent),
    qwen2-moe 32 and deepseek-v3 32 (MLA and MoE), the MoE ones under
    the drop-free ragged dispatch as in the reference's test:
      - ``decode_step``'s logits against the reference's, step by step,
        rtol and atol 1e-4;
      - the caches after the last step, leaf by leaf by
        ``flatten_tree`` path (``layers/<g>/attn/k``, ...), 1e-4;
      - the port's decode against its own full forward, 5e-4 (the
        reference test's bound);
  * whisper: ``populate_encoder_cache`` (``enc_out`` and every layer's
    ``cross_kv``) against the reference's, then 24 steps against the
    reference's and against the teacher-forced forward;
  * paligemma: 8 ``decode_step``s against the reference's (the
    reference's own test checks only shapes);
  * a batch whose two rows sit at different positions: each row equals
    its own batch-of-one decode, and the batch equals the reference's
    step on the same per-row ``pos``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.convert import flatten_tree, params_from_jax
from repro_torch.models import model as TM
from test_torch_minitron import jax_weights

DECODE_ARCHS = [("llama3.2-3b", 32), ("gemma3-1b", 192), ("mamba2-2.7b", 64),
                ("hymba-1.5b", 128), ("minitron-4b", 32),
                ("minicpm3-4b", 32), ("qwen2-moe-a2.7b", 32),
                ("deepseek-v3-671b", 32)]
B = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models are small: one intra-op thread keeps them from
    oversubscribing the cores when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cache(cache):
    """The reference's cache as the port's flat paths (``enc_out`` None
    dropped)."""
    flat = flatten_tree(jax.tree.map(
        lambda a: a if a is None else np.asarray(a), cache,
        is_leaf=lambda a: a is None))
    return {k: v for k, v in flat.items() if v is not None}


def _allclose(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _jax_step(jcfg):
    return jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))


def _pos(i, b=B):
    return (jnp.full((b,), i, jnp.int32),
            torch.full((b,), i, dtype=torch.int32))


def _decode_both(arch, seqlen, weights, extra=None, populate=None):
    """Both packages' decode of one seeded token batch from the same
    weights: the step logits (S, B, V) of each, the caches after the last
    step, and the port's full forward logits. An MoE model runs the
    ragged dispatch (the reduced configs' gshard drops differ between a
    forward and the one-token steps, as the reference's test says)."""
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    if tcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe_impl="ragged")
        tcfg = dataclasses.replace(tcfg, moe_impl="ragged")
    tp = params_from_jax(weights, device="cpu")
    jp = jax.tree.map(jnp.asarray, weights)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, seqlen)).astype(np.int32)
    jc = JM.init_cache(jcfg, B, seqlen)
    tc = TM.init_cache(tcfg, B, seqlen, device="cpu")
    assert sorted(tc) == sorted(_jax_cache(jc))
    if populate is not None:
        jc, tc = populate(jcfg, tcfg, jp, tp, jc, tc)
    step = _jax_step(jcfg)
    jl, tl = [], []
    with torch.no_grad():
        for i in range(seqlen):
            jpos, tpos = _pos(i)
            lg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jpos)
            jl.append(np.asarray(lg[:, 0]))
            lg, tc = TM.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, i:i + 1]), tpos)
            tl.append(lg[:, 0].numpy())
        batch = {"tokens": torch.from_numpy(toks), **(extra or {})}
        full = TM.forward(tcfg, tp, batch)[0].numpy()
    return dict(jax=np.stack(jl), torch=np.stack(tl), jcache=_jax_cache(jc),
                tcache=tc, full=np.moveaxis(full, 1, 0))


@pytest.fixture(scope="module")
def decoded():
    """One decode run of each arch, shared by its three checks."""
    runs = {}

    def get(arch, seqlen):
        if arch not in runs:
            runs[arch] = _decode_both(arch, seqlen, jax_weights(arch))
        return runs[arch]

    return get


@pytest.mark.parametrize("arch,seqlen", DECODE_ARCHS)
def test_decode_step_logits_match_jax(decoded, arch, seqlen):
    run = decoded(arch, seqlen)
    _allclose(run["torch"], run["jax"], 1e-4, arch)


@pytest.mark.parametrize("arch,seqlen", DECODE_ARCHS)
def test_caches_match_jax(decoded, arch, seqlen):
    run = decoded(arch, seqlen)
    assert sorted(run["tcache"]) == sorted(run["jcache"])
    for k, v in run["jcache"].items():
        assert run["tcache"][k].dtype == getattr(torch, v.dtype.name), k
        _allclose(run["tcache"][k], v, 1e-4, f"{arch} {k}")


@pytest.mark.parametrize("arch,seqlen", DECODE_ARCHS)
def test_decode_matches_own_forward(decoded, arch, seqlen):
    run = decoded(arch, seqlen)
    err = float(np.abs(run["torch"] - run["full"]).max())
    assert err < 5e-4, f"{arch}: decode/forward mismatch {err}"


def test_ring_buffer_and_latent_cache_layouts(decoded):
    """gemma3's "W" layers keep a window-sized ring (64 slots for 192
    tokens), its "F" layer every token; minicpm3 caches only the latent
    and the RoPE key; mamba2's state is fp32."""
    cfg = get_reduced("gemma3-1b")
    kv = (cfg.num_kv_heads, cfg.head_dim)
    gemma = decoded("gemma3-1b", 192)["tcache"]
    assert cfg.sliding_window == 64 and cfg.layer_pattern == "WF"
    assert gemma["layers/0/attn/k"].shape == (1, B, 64, *kv)
    assert gemma["layers/1/attn/k"].shape == (1, B, 192, *kv)
    mla = decoded("minicpm3-4b", 32)["tcache"]
    assert sorted(mla) == ["layers/0/attn/ckv", "layers/0/attn/k_rope"]
    assert mla["layers/0/attn/ckv"].shape == (2, B, 32, 64)
    assert mla["layers/0/attn/k_rope"].shape == (2, B, 32, 16)
    mamba = decoded("mamba2-2.7b", 64)["tcache"]
    assert mamba["layers/0/mamba/state"].dtype == torch.float32


def test_whisper_encoder_cache_and_decode_match_jax():
    arch, seqlen = "whisper-tiny", 24
    cfg = get_reduced(arch)
    frames = np.random.default_rng(2).standard_normal(
        (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    filled = {}

    def populate(jcfg, tcfg, jp, tp, jc, tc):
        jc = JM.populate_encoder_cache(jcfg, jp, jc, jnp.asarray(frames))
        with torch.no_grad():
            tc = TM.populate_encoder_cache(tcfg, tp, tc,
                                           torch.from_numpy(frames))
        want = _jax_cache(jc)
        assert sorted(tc) == sorted(want)
        assert "enc_out" in want and "layers/0/cross_kv/1" in want
        for k, v in want.items():
            _allclose(tc[k], v, 1e-4, f"populated {k}")
        filled["n"] = len(want)
        return jc, tc

    run = _decode_both(arch, seqlen, jax_weights(arch),
                       extra={"frames": torch.from_numpy(frames)},
                       populate=populate)
    assert filled["n"] == 5  # enc_out; attn k, v and cross_kv 0, 1 (stacked)
    _allclose(run["torch"], run["jax"], 1e-4, arch)
    for k, v in run["jcache"].items():
        _allclose(run["tcache"][k], v, 1e-4, k)
    assert float(np.abs(run["torch"] - run["full"]).max()) < 5e-4


def test_paligemma_decode_steps_match_jax():
    arch, steps = "paligemma-3b", 8
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    weights = jax_weights(arch)
    tp = params_from_jax(weights, device="cpu")
    jp = jax.tree.map(jnp.asarray, weights)
    length = jcfg.num_prefix_tokens + steps
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, steps)).astype(np.int32)
    jc = JM.init_cache(jcfg, B, length)
    tc = TM.init_cache(tcfg, B, length, device="cpu")
    step = _jax_step(jcfg)
    with torch.no_grad():
        for i in range(steps):
            jpos, tpos = _pos(i)
            jl, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jpos)
            tl, tc = TM.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, i:i + 1]), tpos)
            assert tl.shape == (B, 1, tcfg.vocab_size)
            _allclose(tl, np.asarray(jl), 1e-4, f"step {i}")
    for k, v in _jax_cache(jc).items():
        _allclose(tc[k], v, 1e-4, k)


def _stack_rows(caches):
    """Batch-of-one caches -> one cache, rows in order (batch is dim 1,
    after the layer axis; ``enc_out`` has none)."""
    return {k: torch.cat([c[k] for c in caches], dim=0 if k == "enc_out"
                         else 1) for k in caches[0]}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma3-1b", "mamba2-2.7b",
                                  "minicpm3-4b"])
def test_rows_at_different_positions(arch):
    """Row 1 runs ``ahead`` tokens ahead of row 0 (gemma3's row 1 wraps
    its 64-slot ring while row 0 has not filled it): each row of the
    batch step equals its batch-of-one decode within 1e-5, and the batch
    equals the reference's step on the same per-row positions."""
    ahead, steps, n = 40, 40, 80
    jcfg, tcfg = jax_get_reduced(arch), get_reduced(arch)
    weights = jax_weights(arch)
    tp = params_from_jax(weights, device="cpu")
    jp = jax.tree.map(jnp.asarray, weights)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, n)).astype(np.int32)

    def one(row, start, stop, cache):
        out = []
        for i in range(start, stop):
            lg, cache = TM.decode_step(
                tcfg, tp, cache, torch.from_numpy(toks[row:row + 1, i:i + 1]),
                torch.full((1,), i, dtype=torch.int32))
            out.append(lg[0, 0])
        return out, cache

    with torch.no_grad():
        _, ahead_cache = one(1, 0, ahead, TM.init_cache(tcfg, 1, n,
                                                         device="cpu"))
        pair = _stack_rows([TM.init_cache(tcfg, 1, n, device="cpu"),
                            {k: v.clone() for k, v in ahead_cache.items()}])
        rows = [one(0, 0, steps, TM.init_cache(tcfg, 1, n, device="cpu"))[0],
                one(1, ahead, ahead + steps, ahead_cache)[0]]
        jc = None
        step = _jax_step(jcfg)
        for i in range(steps):
            pos = np.array([i, ahead + i], np.int32)
            tok = np.stack([toks[0, i:i + 1], toks[1, ahead + i:ahead + i + 1]])
            if jc is None:  # the reference's cache from the port's rows
                # (copies: jax may alias a numpy buffer, which the port's
                # in-place writes would then change under it)
                jc = jax.tree.unflatten(
                    jax.tree.structure(JM.init_cache(jcfg, 2, n)),
                    [jnp.asarray(pair[k].numpy().copy())
                     for k in sorted(pair, key=_ref_order(jcfg, n))])
            jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
            tl, pair = TM.decode_step(tcfg, tp, pair, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
            for r in range(2):
                _allclose(tl[r, 0], rows[r][i].numpy(), 1e-5, f"row {r}")
            _allclose(tl, np.asarray(jl), 1e-4, f"step {i}")


def _ref_order(jcfg, n):
    """Sort key: the port's cache paths in the reference's leaf order."""
    order = list(_jax_cache(JM.init_cache(jcfg, 2, n)))
    return order.index
