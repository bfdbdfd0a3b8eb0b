"""The grouped product of the routed experts: rows of ``a`` sorted by
expert times each expert's matrix (``ops.grouped_mm``), its fp32 CUDA
kernel (``csrc/grouped_mm.cu``) and its plain version (``ref``)."""
from repro_torch.kernels.grouped_mm.ops import (  # noqa: F401
    LAUNCHES,
    grouped_mm,
    grouped_mm_cuda,
    grouped_mm_wgrad_cuda,
    reset_launches,
)
