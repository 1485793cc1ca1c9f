"""Flash attention (forward, GQA): the CUDA kernel, its plain version, the op."""
