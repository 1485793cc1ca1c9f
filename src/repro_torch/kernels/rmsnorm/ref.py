"""Plain PyTorch version of the fused RMSNorm kernel (the JAX package's
``kernels/rmsnorm/ref.py``): the CPU path of the wrapper and the card's
reference."""

import torch


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """x: (R, D); w: (D,).  ``x·rsqrt(mean(x²)+eps)·w`` in f32, in x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
