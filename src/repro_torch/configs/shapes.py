"""The four input shapes and the per-(arch, shape) round plans: a copy of
the JAX package's ``configs/shapes.py``."""
from __future__ import annotations

from repro_torch.configs.base import FedRoundSpec, InputShape

SHAPES = {
    "train_4k": InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

# the architectures that run long_500k (a windowed or state-space decode)
LONG_CONTEXT_ARCHS = ("hymba-1.5b", "gemma3-1b", "mamba2-2.7b")


def supports_shape(arch_name: str, shape_name: str) -> bool:
    """Whether ``arch_name`` runs ``shape_name``: every arch runs every
    shape but long_500k, which only ``LONG_CONTEXT_ARCHS`` run."""
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def default_round_spec(arch_name: str, algorithm: str = "scaffold") -> FedRoundSpec:
    """The round plan of train_4k (global_batch 256 = S*K*b_local).

    deepseek-v3-671b takes the client_sequential strategy with 2 sampled
    clients a round, so that x, c and the sampled c_i fit; every other
    arch 16 clients of 4 local steps of 4 sequences.
    """
    if arch_name == "deepseek-v3-671b":
        return FedRoundSpec(
            algorithm=algorithm,
            num_clients=64,
            num_sampled=2,
            local_steps=4,
            local_batch=32,
            strategy="client_sequential",
        )
    return FedRoundSpec(
        algorithm=algorithm,
        num_clients=128,
        num_sampled=16,
        local_steps=4,
        local_batch=4,
        strategy="client_parallel",
    )
