"""Plain PyTorch versions of the RMSNorm kernels (the JAX package's
``kernels/rmsnorm/ref.py`` for the forward; the backward is the port's
own): the CPU path of the wrapper and the card's reference."""

import torch


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """x: (R, D); w: (D,).  ``x·rsqrt(mean(x²)+eps)·w`` in f32, in x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-6):
    """The gradients of :func:`rmsnorm_ref`: x, dy (R, D); w (D,) ->
    ``(dx, dw)``.  With r = rsqrt(mean(x²)+eps), xhat = x r and g = dy w:
    dx = r (g - xhat mean(g xhat)) in x's dtype, dw = sum over rows of
    dy xhat in w's; computed in f32."""
    xf, wf, gf = x.float(), w.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xhat = xf * r
    g = gf * wf
    dx = r * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    dw = (gf * xhat).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)
