"""Trainer checkpoints in the JAX package's ``.npz`` layout."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_serving_params,
    load_trainer,
    save_checkpoint,
    save_trainer,
)
