"""Local-solver optimizer step (the JAX package's ``optim/sgd.py``):
plain SGD, the paper's local solver, with an optional heavy-ball slot."""
from __future__ import annotations


def sgd_step(params, grads, lr, *, momentum: float = 0.0, velocity=None):
    """``(new_params, new_velocity)`` over like-keyed dicts of tensors.
    With ``momentum`` and a ``velocity`` tree: ``v' = momentum*v + g`` (g
    in v's dtype), the step along v'; else the step along g (and the
    velocity passes through). Each new leaf is ``p - lr*u`` computed in
    fp32 and rounded once to p's dtype, as XLA's fused elementwise step
    of the reference rounds a bf16 leaf."""
    if momentum and velocity is not None:
        velocity = {k: momentum * v + grads[k].to(v.dtype)
                    for k, v in velocity.items()}
        update = velocity
    else:
        update = grads
    new_params = {k: (p.float() - lr * update[k].float()).to(p.dtype)
                  for k, p in params.items()}
    return new_params, velocity
