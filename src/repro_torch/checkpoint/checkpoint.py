"""Checkpoints of the trainer's whole state as flat ``.npz`` archives
(the JAX package's ``checkpoint/checkpoint.py``, in its layout).

An archive holds one array a leaf under its "/"-joined path and a
``__meta__`` JSON string: ``{"keys": sorted paths, "extra": {...}}``. A
trainer's tree is ``x``, ``c``, ``opt_state``, ``store`` (every client's
``c_i`` row), ``residuals`` and ``solver_slots`` (their rows, where the
codec or the solver keeps them) and, under an update space that trains a
subset, the frozen ``base``; ``extra`` holds the round counter, the host
RNG states and the space's selection. The port's trees are flat dicts
keyed by the reference's leaf paths, so a key reads the same in both
packages and a checkpoint crosses them, and the engines and stores: a
scanned trainer's device store is synced to its host stores on save and
pushed back on restore, a tiered store's write-backs land before it is
read, and a pipelined trainer records its host RNG states rewound past
the rounds it prepared ahead.

numpy has no bfloat16: a bf16 leaf is written as its raw 2-byte words
(dtype ``|V2``, what ``np.savez`` makes of the reference's bf16 leaves)
and read back as bf16, by the template's dtype in :func:`load_trainer`
and always in the template-free :func:`load_serving_params`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_RAW_BF16 = np.dtype("V2")


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts of tensors -> ``{"a/b/c": tensor}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(_RAW_BF16)
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, key: str,
               device) -> torch.Tensor:
    """An archive array as a tensor of ``dtype`` on ``device``; raises
    when the stored dtype is another."""
    if arr.dtype == _RAW_BF16:
        if dtype != torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key!r} holds bf16 words, "
                             f"the template wants {dtype}")
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype != dtype:
            raise ValueError(f"checkpoint leaf {key!r} is {t.dtype}, the "
                             f"template wants {dtype}")
    return t.to(device)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, for a bitwise comparison."""
    return t.detach().reshape(-1).view(torch.uint8)


def save_checkpoint(path: str, tree, extra: Dict[str, Any] | None = None):
    """Write ``tree`` (nested dicts of tensors) and ``extra`` (JSON)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    meta = {"keys": sorted(flat), "extra": extra or {}}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def _read_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, Any]]:
    """The archive's flat arrays and its ``extra`` metadata."""
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in meta["keys"]}
    return flat, meta["extra"]


def _unflatten_into(flat: Dict[str, np.ndarray], template, prefix=""):
    """The template's structure with each leaf read from ``flat`` (same
    shape and dtype, on the template leaf's device)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(flat, v, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in template.items()}
    arr = flat[prefix]
    if arr.shape != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {prefix!r} has shape "
                         f"{arr.shape}, the template {tuple(template.shape)}")
    # a template on the meta device (a store's rows) reads to the host
    device = "cpu" if template.device.type == "meta" else template.device
    return _to_tensor(arr, template.dtype, prefix, device)


def load_checkpoint(path: str, template) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``template``; returns ``(tree,
    extra)``."""
    flat, extra = _read_checkpoint(path)
    return _unflatten_into(flat, template), extra


def _store_rows(store, rows: bool):
    """A store's ``(N, ...)`` rows (the dense backend's own tensors, else a
    gather of all N), or with ``rows`` False their shapes on the meta
    device, a template to read into."""
    if rows:
        return store.all_rows()
    return {k: torch.empty((store.num_clients,) + shape, dtype=dtype,
                           device="meta")
            for k, (shape, dtype) in store.template.items()}


def _trainer_tree(trainer, rows: bool = True) -> Dict[str, Any]:
    """The trainer's arrays under the checkpoint's stable keys; the store
    rows as :func:`_store_rows` gives them."""
    tree = {
        "x": trainer.server.x,
        "c": trainer.server.c,
        "opt_state": trainer.server.opt_state,
        "store": _store_rows(trainer.store, rows),
    }
    if trainer.residual_store is not None:
        tree["residuals"] = _store_rows(trainer.residual_store, rows)
    if trainer.solver_store is not None:
        tree["solver_slots"] = _store_rows(trainer.solver_store, rows)
    if trainer.base_params is not None:
        # the frozen base rides with the deltas, so the checkpoint serves
        # without the training config (load_serving_params)
        tree["base"] = trainer.base_params
    return tree


def save_trainer(path: str, trainer):
    """Checkpoint a ``FederatedTrainer``: its ``ServerState``, every
    client's rows, the round counter, the host RNG states and the update
    space's selection. A scanned trainer's device store is mirrored into
    its host stores first, and a tiered trainer's write-backs land, so
    the archive is the same in every engine and store; a pipelined
    trainer's RNG states are rewound past its prepared rounds
    (``host_rng_state``), which a restore prepares again."""
    trainer.sync_host_store()
    extra = {"round": trainer.round_idx,
             "host_rng": trainer.host_rng_state()}
    if trainer.update_space.trains_subset:
        extra["update_space"] = trainer.update_space.checkpoint_meta(
            trainer.spec)
    save_checkpoint(path, _trainer_tree(trainer), extra=extra)


def load_trainer(path: str, trainer):
    """Restore a ``save_trainer`` checkpoint into a trainer built with
    the same spec, model and dataset. Raises when the checkpoint was
    trained in another update space, or when its frozen base differs by
    one bit from the trainer's (the deltas would land on other weights)."""
    flat, extra = _read_checkpoint(path)
    saved_space = extra.get("update_space", {"name": "full"})["name"]
    if saved_space != trainer.update_space.name:
        raise ValueError(
            f"checkpoint was trained in update_space={saved_space!r} but "
            f"the trainer is configured for {trainer.update_space.name!r}; "
            f"restore into a matching FedRoundSpec")
    template = _trainer_tree(trainer, rows=False)
    if "base" in template:
        for key, cur in trainer.base_params.items():
            saved = _unflatten_into(flat, cur, f"base/{key}")
            if not torch.equal(_bits(saved), _bits(cur)):
                raise ValueError(
                    f"checkpoint base parameters differ from the trainer's "
                    f"(leaf {key!r}): the trainer must be constructed with "
                    f"the same model init (same seed/config) as the saved "
                    f"run")
            del saved
        del template["base"]
    tree = _unflatten_into(flat, template)
    del flat
    trainer.server = dataclasses.replace(
        trainer.server, x=tree["x"], c=tree["c"],
        opt_state=tree["opt_state"])
    all_ids = np.arange(trainer.store.num_clients)
    trainer.store.scatter(all_ids, tree["store"])
    if trainer.residual_store is not None:
        trainer.residual_store.scatter(all_ids, tree["residuals"])
    if trainer.solver_store is not None:
        trainer.solver_store.scatter(all_ids, tree["solver_slots"])
    trainer.push_host_store_to_device()
    trainer.round_idx = int(extra.get("round", 0))
    if "host_rng" in extra:
        trainer.set_host_rng_state(extra["host_rng"])
    return trainer


def _subtree(flat: Dict[str, np.ndarray], prefix: str, device):
    """The flat tree stored under ``prefix``, template-free: raw 2-byte
    words read as bf16."""
    pre = prefix + "/"
    sub = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
    if not sub:
        raise KeyError(f"checkpoint has no tree under {prefix!r}")
    return {k: (_to_tensor(v, torch.bfloat16, pre + k, device)
                if v.dtype == _RAW_BF16
                else torch.from_numpy(np.array(v, copy=True)).to(device))
            for k, v in sub.items()}


def load_serving_params(path: str, device="cuda"):
    """The full parameter tree a ``save_trainer`` checkpoint serves, on
    ``device``: the frozen base with the trained deltas merged through
    the recorded update space, or ``x`` itself for the ``full`` space.
    Needs no trainer, spec or model config."""
    from repro_torch.core.update_space import spec_from_meta

    dev = resolve_device(device)
    flat, extra = _read_checkpoint(path)
    x = _subtree(flat, "x", dev)
    space, shim = spec_from_meta(extra.get("update_space"))
    if not space.trains_subset:
        return x
    with torch.no_grad():
        return space.apply(shim, _subtree(flat, "base", dev), x)
