"""The port's distribution layer (the JAX package's ``repro.dist``): so
far the sharded population-store backend (``dist.store``)."""
