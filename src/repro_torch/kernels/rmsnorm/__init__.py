"""Fused RMSNorm: the hand-written CUDA kernel, its plain version and the op."""
