"""The paper's experiment models (EMNIST §7.3): logistic regression and
a 2-layer MLP, with the ``(params, batch) -> (loss, metrics)`` contract
the federated core consumes (a port of the JAX package's
``models/simple.py``).

Leaves are flat and named as the reference's (``w``, ``b``; ``w1``,
``b1``, ``w2``, ``b2``), so ``convert.params_from_jax`` carries the
reference's weights across unchanged. The losses carry no
``megakernel_grad``: the K-step kernel cannot compute their gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device


def logreg_init(gen, dim: int, num_classes: int, device="cuda"):
    """Zeros (``gen`` is unused, as the reference ignores its key)."""
    dev = resolve_device(device)
    return {
        "b": torch.zeros((num_classes,), dtype=torch.float32, device=dev),
        "w": torch.zeros((dim, num_classes), dtype=torch.float32, device=dev),
    }


def logreg_logits(params, batch):
    return batch["x"] @ params["w"] + params["b"]


def logreg_loss(params, batch) -> Tuple[torch.Tensor, Dict]:
    loss = _xent(logreg_logits(params, batch), batch["y"])
    return loss, {"loss": loss}


def mlp_init(gen, dim: int, num_classes: int, hidden: int = 256,
             device="cuda"):
    """He-style normal weights drawn from ``gen`` (a ``torch.Generator``
    on any device; a fresh one seeded with 0 on ``device`` when None),
    zero biases, on ``device``. The draws differ from the reference's
    threefry keys; shapes and scales are the reference's."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w / torch.tensor(math.sqrt(fan_in), dtype=torch.float32,
                                 device=gen.device)).to(dev)

    w1 = normal((dim, hidden), dim)
    w2 = normal((hidden, num_classes), hidden)
    return {
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=dev),
        "b2": torch.zeros((num_classes,), dtype=torch.float32, device=dev),
        "w1": w1,
        "w2": w2,
    }


def mlp_logits(params, batch):
    h = torch.relu(batch["x"] @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params, batch) -> Tuple[torch.Tensor, Dict]:
    loss = _xent(mlp_logits(params, batch), batch["y"])
    return loss, {"loss": loss}


def _xent(logits, labels):
    """Mean cross-entropy in fp32 (``logsumexp`` minus the gold logit)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def accuracy(predict_logits_fn, params, batch) -> float:
    """Share of ``batch`` whose arg-max logit is its label."""
    logits = predict_logits_fn(params, batch)
    return float(torch.mean((torch.argmax(logits, -1)
                             == batch["y"].long()).float()))
