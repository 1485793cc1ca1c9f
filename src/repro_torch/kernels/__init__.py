"""Hand-written CUDA kernels of the port (counterpart of ``repro.kernels``)."""
