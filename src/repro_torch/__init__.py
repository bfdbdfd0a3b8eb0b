"""PyTorch + CUDA port of the SCAFFOLD federated-learning system.

The JAX package ``repro`` is the reference; this package imports nothing
of it (it keeps its own copies of what it needs) and runs on an NVIDIA
H100 through hand-written CUDA kernels for sm_90a. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
