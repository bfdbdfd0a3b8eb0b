"""The port's models: the llama-family transformer (``model``) and the
paper's EMNIST models (``simple``: logistic regression, a 2-layer MLP)."""
from repro_torch.models.simple import (  # noqa: F401
    accuracy,
    logreg_init,
    logreg_logits,
    logreg_loss,
    mlp_init,
    mlp_logits,
    mlp_loss,
)
