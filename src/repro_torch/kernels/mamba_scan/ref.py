"""Plain PyTorch version of the selective-scan kernel (the JAX package's
``kernels/mamba_scan/ref.py``, sequential over time): the CPU path of the
wrapper and the card's reference.  It also returns the final state, which
the model's prefill keeps for decode.  Its fused mode is the mamba1 block's
own sequence around the scan (``models/mamba.py``), op for op."""

import torch
import torch.nn.functional as F


def selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, *, dt_bias=None, z=None):
    """dt/x: (B, S, DI); a_log: (DI, N); b_ssm/c_ssm: (B, S, N); d_skip: (DI,).

    ``h_t = exp(dt_t·(-exp(A_log)))·h_{t-1} + (dt_t·x_t)·B_t`` from h = 0,
    ``y_t = Σ_n h_t·C_t + D·x_t``, all in f32.  Returns ``(y (B, S, DI) in
    dt's dtype, h_S (B, DI, N) f32)``.

    With ``dt_bias`` and ``z`` (the fused mode), ``dt`` is dt_pre and the
    result is the block's ``((y with dt = softplus(dt_pre + dt_bias), dt and
    x in f32) · silu(z in f32)).to(x.dtype)``, rounding where the block
    rounds."""
    if z is not None:
        dt = F.softplus(dt + dt_bias)
        y, h = selective_scan_ref(dt.float(), a_log, b_ssm, c_ssm, x.float(), d_skip)
        return (y * F.silu(z.float())).to(x.dtype), h
    bsz, s, di = dt.shape
    n = a_log.shape[1]
    a = -torch.exp(a_log.float())
    d = d_skip.float()
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=dt.device)
    ys = torch.empty((bsz, s, di), dtype=torch.float32, device=dt.device)
    for t in range(s):
        dt_t = dt[:, t].float()
        x_t = x[:, t].float()
        abar = torch.exp(dt_t[..., None] * a[None])
        h = abar * h + (dt_t * x_t)[..., None] * b_ssm[:, t, None, :].float()
        ys[:, t] = (h * c_ssm[:, t, None, :].float()).sum(-1) + d * x_t
    return ys.to(dt.dtype), h
