"""Step-size schedules (the JAX package's ``optim``)."""
