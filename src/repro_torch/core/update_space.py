"""The update-space registry (the JAX package's ``core/update_space.py``):
the map between the full parameter tree and the trainable-delta tree
the federated engine trains.

The round engine is generic over ``server.x``: ``c``, the ``c_i`` rows,
the codec's residual rows, the solver's slot rows and
``bytes_up``/``bytes_down`` all follow its shapes. A space that trains a
subset freezes the base parameters once, makes ``server.x`` its delta
tree, and the trainer differentiates in delta space:

    grad(deltas) = grad_project(base, deltas, dLoss/dW at W = apply(base, deltas))

  full       the identity: the deltas are the parameters, no base (the
             trainer keeps its unwrapped grad fn, so every trajectory is
             the one it was).
  lora       low-rank factors on each targeted weight ``W (…, in, out)``:
             ``A (…, in, r)`` drawn normal over ``sqrt(in)`` and
             ``B (…, r, out)`` zero, merged as
             ``(W.float() + (alpha/r) · A @ B).to(W.dtype)``.
  head_only  the targeted leaves themselves train; the rest is frozen.

Trees are the port's flat dicts (``{"layers/0/attn/wq": tensor}``). A
delta key is the parameter's path with "/" escaped to ".", and a LoRA
factor hangs below it: ``"layers.0.attn.wq/A"``. That is what
``convert.flatten_tree`` makes of the reference's delta tree, and what
the reference's checkpoints hold under ``x/``. Targets are comma-separated
fnmatch patterns, matched against the escaped path and its last
component.
"""
from __future__ import annotations

import fnmatch
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import streams
from repro_torch.core.tree import leaf_keys

# the dense matmul weights of the models: the default LoRA targets
DEFAULT_LORA_TARGETS: Tuple[str, ...] = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_SEP = "."  # the path separator inside a delta key


def leaf_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    """``(escaped path, leaf)`` pairs of a flat tree, in the reference's
    flatten order."""
    return [(k.replace("/", _SEP), tree[k]) for k in leaf_keys(tree)]


def _matches(path: str, patterns: Sequence[str]) -> bool:
    """fnmatch against the escaped path and its last component."""
    name = path.rsplit(_SEP, 1)[-1]
    return any(fnmatch.fnmatch(path, pat) or fnmatch.fnmatch(name, pat)
               for pat in patterns)


def _target_patterns(spec) -> Tuple[str, ...]:
    raw = getattr(spec, "update_targets", "") or ""
    return tuple(p.strip() for p in raw.split(",") if p.strip())


def _param_key(base, path: str) -> str:
    """The key of ``base`` whose escaped path is ``path``."""
    key = path.replace(_SEP, "/")
    if key not in base:
        raise KeyError(f"no parameter at delta path {path!r}")
    return key


class UpdateSpace:
    """A named map full parameters <-> trainable deltas.

    Subclasses set ``name`` and the flags and implement ``init_deltas``
    and ``apply``. The default ``grad_project`` is autograd through
    ``apply`` (the exact chain rule); the built-ins give the closed form.
    """

    name = "base"
    #: False only for the identity space
    trains_subset = True
    #: the space reads spec.lora_rank / spec.lora_alpha
    uses_rank = False
    #: the space needs a non-empty spec.update_targets
    requires_targets = False

    def init_deltas(self, spec, params, key=None):
        """The round-0 delta tree of ``params`` (``key``: a
        ``streams.StreamKey``); ``apply(spec, params, init_deltas(...))``
        equals ``params``."""
        raise NotImplementedError

    def apply(self, spec, base, deltas):
        """The full parameter tree the model consumes (base leaves that
        the deltas do not touch are shared, not copied)."""
        raise NotImplementedError

    def grad_keys(self, spec, base, deltas) -> List[str]:
        """The keys of the full tree whose gradient ``grad_project``
        reads: the only leaves the trainer differentiates."""
        return list(base)

    def grad_project(self, spec, base, deltas, full_grads):
        """``(d apply / d deltas)^T full_grads`` over the leaves of
        ``grad_keys``."""
        with torch.enable_grad():
            d = {k: v.detach().requires_grad_(True) for k, v in
                 deltas.items()}
            merged = self.apply(spec, base, d)
            keys = list(full_grads)
            got = torch.autograd.grad([merged[k] for k in keys],
                                      list(d.values()),
                                      [full_grads[k] for k in keys],
                                      allow_unused=True)
        return {k: (torch.zeros_like(v) if g is None else g)
                for (k, v), g in zip(d.items(), got)}

    def num_params(self, deltas) -> int:
        """Trainable scalars of a delta tree."""
        return sum(v.numel() for v in deltas.values())

    def checkpoint_meta(self, spec) -> Dict[str, Any]:
        """What a checkpoint records so that serving can rebuild the
        space without the training config."""
        return {"name": self.name}


class FullSpace(UpdateSpace):
    """The identity: the deltas are the parameters."""

    name = "full"
    trains_subset = False

    def init_deltas(self, spec, params, key=None):
        return params

    def apply(self, spec, base, deltas):
        return deltas

    def grad_project(self, spec, base, deltas, full_grads):
        return full_grads


class LoRASpace(UpdateSpace):
    """Low-rank adapters on the targeted matmul weights (trailing axes
    ``(in, out)``; leading axes, the stacked layers, batch the factors).
    ``spec.update_targets`` empty means :data:`DEFAULT_LORA_TARGETS`."""

    name = "lora"
    uses_rank = True

    def _rank_alpha(self, spec) -> Tuple[int, float]:
        rank = int(getattr(spec, "lora_rank", 0) or 0)
        if rank <= 0:
            raise ValueError(
                "update_space='lora' needs lora_rank >= 1 (rank 0 would "
                "train nothing — pass --lora-rank / FedRoundSpec.lora_rank)")
        alpha = float(getattr(spec, "lora_alpha", 0.0) or rank)
        return rank, alpha

    def targets(self, spec, params) -> List[Tuple[str, torch.Tensor]]:
        pats = _target_patterns(spec) or DEFAULT_LORA_TARGETS
        hits = [(p, leaf) for p, leaf in leaf_paths(params)
                if _matches(p, pats)]
        if not hits:
            raise ValueError(
                f"update_space='lora' matched no parameters: patterns "
                f"{pats} vs leaves {[p for p, _ in leaf_paths(params)]}")
        bad = [(p, tuple(leaf.shape)) for p, leaf in hits if leaf.dim() < 2]
        if bad:
            raise ValueError(
                f"lora targets must be >=2-D matmul weights, got {bad}; "
                f"narrow update_targets")
        return hits

    def init_deltas(self, spec, params, key=None):
        rank, _ = self._rank_alpha(spec)
        hits = self.targets(spec, params)
        if key is None:
            key = streams.stream_key(0, next(iter(params.values())).device)
        deltas = {}
        for i, (path, leaf) in enumerate(hits):
            *lead, d_in, d_out = leaf.shape
            a = streams.normal(key.fold_in(i), (*lead, d_in, rank))
            a = a / torch.sqrt(torch.tensor(d_in, dtype=torch.float32,
                                            device=a.device))
            deltas[f"{path}/A"] = a.to(leaf.device)
            deltas[f"{path}/B"] = torch.zeros((*lead, rank, d_out),
                                              dtype=torch.float32,
                                              device=leaf.device)
        return deltas

    @staticmethod
    def _factors(deltas) -> List[str]:
        return [k[:-2] for k in deltas if k.endswith("/A")]

    def apply(self, spec, base, deltas):
        rank, alpha = self._rank_alpha(spec)
        scale = alpha / rank
        merged = dict(base)
        for path in self._factors(deltas):
            key = _param_key(base, path)
            w = base[key]
            upd = torch.matmul(deltas[f"{path}/A"].float(),
                               deltas[f"{path}/B"].float())
            merged[key] = (w.float() + scale * upd).to(w.dtype)
        return merged

    def grad_keys(self, spec, base, deltas) -> List[str]:
        return [_param_key(base, p) for p in self._factors(deltas)]

    def grad_project(self, spec, base, deltas, full_grads):
        rank, alpha = self._rank_alpha(spec)
        scale = alpha / rank
        out = {}
        for path in self._factors(deltas):
            g = full_grads[_param_key(base, path)].float()
            a = deltas[f"{path}/A"].float()
            b = deltas[f"{path}/B"].float()
            out[f"{path}/A"] = scale * torch.matmul(g, b.transpose(-1, -2))
            out[f"{path}/B"] = scale * torch.matmul(a.transpose(-1, -2), g)
        return {k: out[k] for k in deltas}

    def checkpoint_meta(self, spec) -> Dict[str, Any]:
        rank, alpha = self._rank_alpha(spec)
        return {"name": self.name, "lora_rank": rank, "lora_alpha": alpha,
                "update_targets": getattr(spec, "update_targets", "") or ""}


class HeadOnlySpace(UpdateSpace):
    """Only the leaves matching ``spec.update_targets`` train, at their
    full shape and dtype; the deltas are the leaves' values, so
    ``apply`` substitutes them."""

    name = "head_only"
    requires_targets = True

    def targets(self, spec, params) -> List[Tuple[str, torch.Tensor]]:
        pats = _target_patterns(spec)
        if not pats:
            raise ValueError(
                "update_space='head_only' needs update_targets (e.g. "
                "'unembed*,ln_final*') — an empty selection trains nothing")
        hits = [(p, leaf) for p, leaf in leaf_paths(params)
                if _matches(p, pats)]
        if not hits:
            raise ValueError(
                f"update_space='head_only' matched no parameters: patterns "
                f"{pats} vs leaves {[p for p, _ in leaf_paths(params)]}")
        return hits

    def init_deltas(self, spec, params, key=None):
        return dict(self.targets(spec, params))

    def apply(self, spec, base, deltas):
        merged = dict(base)
        for path, leaf in deltas.items():
            merged[_param_key(base, path)] = leaf
        return merged

    def grad_keys(self, spec, base, deltas) -> List[str]:
        return [_param_key(base, p) for p in deltas]

    def grad_project(self, spec, base, deltas, full_grads):
        return {p: full_grads[_param_key(base, p)] for p in deltas}

    def checkpoint_meta(self, spec) -> Dict[str, Any]:
        return {"name": self.name,
                "update_targets": getattr(spec, "update_targets", "") or ""}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_UPDATE_SPACES: Dict[str, UpdateSpace] = {}


def register_update_space(space: UpdateSpace) -> UpdateSpace:
    """Register an ``UpdateSpace`` instance under its ``name``."""
    assert space.name and space.name != "base", space.name
    _UPDATE_SPACES[space.name] = space
    return space


def get_update_space(name: str) -> UpdateSpace:
    """Look up a registered update space; unknown names fail loudly."""
    try:
        return _UPDATE_SPACES[name]
    except KeyError:
        raise KeyError(f"unknown update space {name!r}; known: "
                       f"{update_space_names()}") from None


def update_space_names() -> Tuple[str, ...]:
    """Sorted names of all registered update spaces."""
    return tuple(sorted(_UPDATE_SPACES))


def resolve_update_space(spec) -> str:
    """The spec's update-space name ("full" when unset)."""
    return getattr(spec, "update_space", "") or "full"


def spec_from_meta(meta: Optional[Dict[str, Any]]):
    """``(space, spec-like)`` from the metadata ``checkpoint_meta`` wrote:
    what merging a base + deltas checkpoint needs without the training
    config."""
    meta = meta or {"name": "full"}
    space = get_update_space(meta["name"])
    shim = SimpleNamespace(
        update_space=meta["name"],
        lora_rank=int(meta.get("lora_rank", 0) or 0),
        lora_alpha=float(meta.get("lora_alpha", 0.0) or 0.0),
        update_targets=meta.get("update_targets", ""))
    return space, shim


for _sp in (FullSpace(), LoRASpace(), HeadOnlySpace()):
    register_update_space(_sp)
