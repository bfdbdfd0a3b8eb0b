"""The fused SCAFFOLD update kernels: the per-step corrected update (B1,
``ops``) and the K-step local loop on quadratics (B3, ``megakernel``)."""
from repro_torch.kernels.scaffold_update.ops import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    scaffold_update,
    scaffold_update_packed,
)
