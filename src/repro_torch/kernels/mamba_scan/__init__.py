"""Mamba1 selective scan: the CUDA kernel, its plain version and the op."""
