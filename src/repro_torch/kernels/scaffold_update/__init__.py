"""The fused SCAFFOLD update kernels: the per-step corrected and
heavy-ball updates (B1, B2, ``ops``) and the K-step local loops on
quadratics (B3, B4, ``megakernel``)."""
from repro_torch.kernels.scaffold_update.ops import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    scaffold_momentum_update,
    scaffold_momentum_update_packed,
    scaffold_update,
    scaffold_update_packed,
)
