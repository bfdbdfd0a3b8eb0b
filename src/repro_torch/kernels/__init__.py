"""Hand-written CUDA kernels of the port (built by ``kernels/build.py``)."""
