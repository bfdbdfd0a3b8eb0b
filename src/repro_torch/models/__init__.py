"""The port's models: the llama-family transformer (``model``: init,
forward, loss and the serving substrate) and the paper's EMNIST models
(``simple``: logistic regression, a 2-layer MLP)."""
from repro_torch.models.model import (  # noqa: F401
    count_active_params,
    count_params_analytic,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    populate_encoder_cache,
    prefill,
)
from repro_torch.models.simple import (  # noqa: F401
    accuracy,
    logreg_init,
    logreg_logits,
    logreg_loss,
    mlp_init,
    mlp_logits,
    mlp_loss,
)
