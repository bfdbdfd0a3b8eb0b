"""Step-size schedules and the local SGD step (the JAX package's
``optim``)."""
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup  # noqa: F401
from repro_torch.optim.sgd import sgd_step  # noqa: F401
