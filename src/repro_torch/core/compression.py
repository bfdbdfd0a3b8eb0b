"""Communication compression for the round's uplink and downlink (the
JAX package's ``core/compression.py``).

A :class:`Compressor` is a codec over a parameter tree with an fp32
error-feedback residual of the tree's shape. Registered codecs:

  ``none``      identity (also the downlink default). Stateless.
  ``int8_ef``   per-leaf symmetric int8 (round half to even) + residual.
  ``topk_ef``   per-leaf top-k by magnitude (k = ``spec.compress_k``),
                values + int32 indices on the wire. Ties in magnitude go
                to the lower index first, as ``lax.top_k`` orders them
                (a stable sort on ``-|x|``; ``torch.topk`` promises no
                order among ties).
  ``randk_ef``  rand-k with shared randomness: leaf ``j`` keeps
                ``permutation(key.fold_in(j))[:k]`` (``core.streams``),
                so only the k values travel.
  ``sign_ef``   1-bit sign with a per-leaf mean-|x| scale (EF-SignSGD).

Trees are the port's flat dicts, or a tuple of them (the downlink's
``(x, c)``); leaf ``j`` counts in the reference's flatten order
(``core.tree.leaf_keys``, the tuple's trees one after another). Payloads
mirror the tree: a dict per leaf under the leaf's key, except
``int8_ef``'s ``{"q": tree, "scale": tree}``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import streams
from repro_torch.core.tree import leaf_keys


def _leaves(tree):
    """The leaves (or payload nodes) of a dict or a tuple of dicts, in
    the reference's flatten order."""
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree[k] for k in leaf_keys(tree)]


def _leaves_up_to(like, payload):
    """The payload's node at each leaf position of ``like``."""
    if isinstance(like, tuple):
        return [n for lt, pt in zip(like, payload)
                for n in _leaves_up_to(lt, pt)]
    return [payload[k] for k in leaf_keys(like)]


def _rebuild(like, nodes):
    """A tree shaped like ``like`` holding ``nodes`` in flatten order."""
    nodes = iter(nodes)

    def build(t):
        if isinstance(t, tuple):
            return tuple(build(s) for s in t)
        return {k: next(nodes) for k in leaf_keys(t)}

    return build(like)


def _map(fn, tree, *others):
    """``fn(leaf, *other_leaves)`` leafwise, shaped like ``tree``."""
    cols = [_leaves(t) for t in (tree,) + others]
    return _rebuild(tree, [fn(*ls) for ls in zip(*cols)])


def _sizes(tree):
    return [leaf.numel() for leaf in _leaves(tree)]


def tree_bytes(tree) -> int:
    """Bytes of an uncompressed tree (the raw wire size)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))


def _f32(tree):
    return _map(lambda a: a.float(), tree)


class Compressor:
    """One uplink/downlink codec over a parameter tree.

    stateful:  lossy, with a client-side fp32 error-feedback residual.
    needs_key: consumes a ``core.streams.StreamKey``; the engine gives
               client ``i`` of round ``t`` the key ``(base, t, 0, i)``
               and the downlink ``(base, t, 1)``.
    """

    name: str = ""
    stateful: bool = True
    needs_key: bool = False

    def encode(self, spec, tree, key=None) -> Any:
        """Tree -> wire payload."""
        raise NotImplementedError

    def decode(self, spec, payload, like) -> Any:
        """Wire payload -> fp32 reconstruction shaped like ``like``."""
        raise NotImplementedError

    def payload_bytes(self, spec, template) -> int:
        """Wire bytes of ``encode(template)``."""
        raise NotImplementedError

    def init_residual(self, template):
        """Fresh residual (fp32 zeros like ``template``), or None for a
        stateless codec."""
        if not self.stateful:
            return None
        return _map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), template)

    def apply_stateless(self, spec, tree, key=None):
        """decode(encode(tree)) in the tree's own dtypes: the downlink
        broadcast (no residual)."""
        rec = self.decode(spec, self.encode(spec, tree, key=key), tree)
        return _map(lambda r, t: r.to(t.dtype), rec, tree)

    def round_trip(self, spec, delta, residual=None, key=None
                   ) -> Tuple[Any, Any]:
        """Error-feedback compression of an uplink ``delta``: adds the
        carried ``residual`` (None = zeros), encodes and decodes, and
        returns ``(reconstruction in delta's dtypes, new fp32
        residual)``. A stateless codec passes ``residual`` through."""
        if not self.stateful:
            return self.apply_stateless(spec, delta, key=key), residual
        d32 = _f32(delta)
        if residual is not None:
            d32 = _map(torch.add, d32, residual)
        rec32 = self.decode(spec, self.encode(spec, d32, key=key), d32)
        new_residual = _map(torch.sub, d32, rec32)
        rec = _map(lambda r, d: r.to(d.dtype), rec32, delta)
        return rec, new_residual


class NoCompression(Compressor):
    """Identity codec, the explicit "compression off" entry."""

    name = "none"
    stateful = False

    def encode(self, spec, tree, key=None):
        return tree

    def decode(self, spec, payload, like):
        return payload

    def payload_bytes(self, spec, template) -> int:
        return tree_bytes(template)


class Int8EF(Compressor):
    """Per-leaf symmetric int8: one fp32 scale per leaf on the wire."""

    name = "int8_ef"

    def encode(self, spec, tree, key=None):
        q, scales = quantize_int8(tree)
        return {"q": q, "scale": scales}

    def decode(self, spec, payload, like):
        return dequantize_int8(payload["q"], payload["scale"])

    def payload_bytes(self, spec, template) -> int:
        return compressed_uplink_bytes(template)


def _top_k_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |flat|, larger first, ties to the lower
    index (a stable sort on -|x|, which is ``lax.top_k``'s order)."""
    order = torch.sort(-flat.abs(), stable=True).indices
    return order[:k]


class TopKEF(Compressor):
    """Per-leaf top-k by magnitude; k = min(spec.compress_k, leaf size).
    The wire carries k (value, int32 index) pairs a leaf."""

    name = "topk_ef"

    def encode(self, spec, tree, key=None):
        def enc(x):
            flat = x.reshape(-1)
            idx = _top_k_indices(flat, min(int(spec.compress_k),
                                           flat.numel()))
            return {"idx": idx.to(torch.int32), "val": flat[idx]}

        return _map(enc, tree)

    def decode(self, spec, payload, like):
        def dec(p, leaf):
            flat = torch.zeros(leaf.numel(), dtype=torch.float32,
                               device=leaf.device)
            flat[p["idx"].long()] = p["val"].float()
            return flat.reshape(leaf.shape)

        return _rebuild(like, [dec(p, leaf) for p, leaf in
                               zip(_leaves_up_to(like, payload),
                                   _leaves(like))])

    def payload_bytes(self, spec, template) -> int:
        return sum(8 * min(int(spec.compress_k), n) for n in _sizes(template))


class RandKEF(Compressor):
    """Rand-k with shared randomness: leaf ``j`` keeps the first k of
    ``streams.permutation(key.fold_in(j), size)``, a pure function of the
    key both ends hold, so only the k values travel (the payload carries
    the key as a simulation convenience). The unsent mass rides the
    residual."""

    name = "randk_ef"
    needs_key = True

    def _mask(self, spec, k_leaf, size: int):
        k = min(int(spec.compress_k), size)
        return streams.permutation(k_leaf, size)[:k]

    def encode(self, spec, tree, key=None):
        if key is None:
            raise ValueError("randk_ef is keyed: pass a comp key "
                             "(engine: run_round(..., comp_key=...))")
        leaves = _leaves(tree)
        nodes = []
        for j, x in enumerate(leaves):
            flat = x.reshape(-1)
            k_leaf = key.fold_in(j)
            nodes.append({"val": flat[self._mask(spec, k_leaf,
                                                 flat.numel())],
                          "key": k_leaf})
        return _rebuild(tree, nodes)

    def decode(self, spec, payload, like):
        def dec(p, leaf):
            idx = self._mask(spec, p["key"], leaf.numel())
            flat = torch.zeros(leaf.numel(), dtype=torch.float32,
                               device=leaf.device)
            flat[idx] = p["val"].float()
            return flat.reshape(leaf.shape)

        return _rebuild(like, [dec(p, leaf) for p, leaf in
                               zip(_leaves_up_to(like, payload),
                                   _leaves(like))])

    def payload_bytes(self, spec, template) -> int:
        return sum(4 * min(int(spec.compress_k), n) for n in _sizes(template))


class SignEF(Compressor):
    """1-bit sign with a per-leaf mean-|x| scale (EF-SignSGD). 0.0
    encodes as +1; its error rides the residual."""

    name = "sign_ef"

    def encode(self, spec, tree, key=None):
        def enc(x):
            xf = x.float()
            return {"sign": torch.where(xf >= 0.0, 1, -1).to(torch.int8),
                    "scale": xf.abs().mean()}

        return _map(enc, tree)

    def decode(self, spec, payload, like):
        return _rebuild(like, [p["sign"].float() * p["scale"]
                               for p in _leaves_up_to(like, payload)])

    def payload_bytes(self, spec, template) -> int:
        return sum(-(-n // 8) + 4 for n in _sizes(template))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


_COMPRESSORS: Dict[str, Compressor] = {}


def register_compressor(codec: Compressor) -> Compressor:
    """Register a ``Compressor`` instance under its ``name``."""
    assert codec.name, "Compressor subclasses must set a name"
    _COMPRESSORS[codec.name] = codec
    return codec


def get_compressor(name: str) -> Compressor:
    """Look up a registered codec; unknown names fail loudly."""
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise KeyError(
            f"unknown compressor {name!r}; registered: {compressor_names()}"
        ) from None


def compressor_names() -> Tuple[str, ...]:
    """Sorted names of all registered codecs."""
    return tuple(sorted(_COMPRESSORS))


for _c in (NoCompression(), Int8EF(), TopKEF(), RandKEF(), SignEF()):
    register_compressor(_c)


def resolve_compressor(spec) -> str:
    """The spec's uplink codec name (``FedRoundSpec`` has already turned
    the back-compat ``compress_uplink`` flag into ``compress``)."""
    return spec.compress


def resolve_downlink(spec) -> str:
    """The spec's downlink codec name."""
    return spec.compress_downlink


def round_comm_bytes(spec, x, *, stateful_clients: bool) -> Dict[str, int]:
    """Exact per-round communicated bytes. Up, per sampled client: dy
    through the uplink codec, plus raw dc for stateful-client algorithms.
    Down, per sampled client: ``(x, c)`` (``x`` alone for stateless
    clients) through the downlink codec."""
    up = get_compressor(spec.compress)
    down = get_compressor(spec.compress_downlink)
    per_up = up.payload_bytes(spec, x)
    if stateful_clients:
        per_up += tree_bytes(x)
    per_down = down.payload_bytes(spec, (x, x) if stateful_clients else (x,))
    return {"bytes_up": spec.num_sampled * per_up,
            "bytes_down": spec.num_sampled * per_down}


# ---------------------------------------------------------------------------
# int8 primitives
# ---------------------------------------------------------------------------


def quantize_int8(tree) -> Tuple[Any, Any]:
    """Per-leaf symmetric int8 quantization. Returns (q_tree, scales)."""

    def q(x):
        xf = x.float()
        scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
        return torch.clamp(torch.round(xf / scale), -127, 127).to(
            torch.int8), scale

    out = [q(leaf) for leaf in _leaves(tree)]
    return (_rebuild(tree, [o[0] for o in out]),
            _rebuild(tree, [o[1] for o in out]))


def dequantize_int8(q_tree, scales, dtype=torch.float32):
    """Inverse of the int8 quantization: ``q * scale`` cast to dtype."""
    return _map(lambda q, s: (q.float() * s).to(dtype), q_tree, scales)


def compress_delta(delta, residual=None):
    """Error-feedback int8 compression of an uplink delta; returns
    ``(quantized, scales, new_residual)``. The engine runs
    ``Int8EF.round_trip``; this helper is kept as the reference's API."""
    if residual is not None:
        delta = _map(lambda d, r: d + r.to(d.dtype), delta, residual)
    q, s = quantize_int8(delta)
    recon = dequantize_int8(q, s)
    new_residual = _map(lambda d, rec: d.float() - rec, delta, recon)
    return q, s, new_residual


def uplink_bytes(tree) -> int:
    """Bytes of an uncompressed uplink tree (the reference's helper; the
    engine reckons bytes with ``round_comm_bytes``)."""
    return tree_bytes(tree)


def compressed_uplink_bytes(tree) -> int:
    """int8 payload + one fp32 scale per leaf."""
    return sum(n + 4 for n in _sizes(tree))
