"""Plain PyTorch versions of the selective-scan kernels: the forward (the
JAX package's ``kernels/mamba_scan/ref.py``, sequential over time) and the
port's own backward.  They are the CPU path of the wrappers and the card's
reference.  The forward also returns the final state, which the model's
prefill keeps for decode.  Its fused mode is the mamba1 block's own
sequence around the scan (``models/mamba.py``), op for op."""

import torch
import torch.nn.functional as F

SOFTPLUS_THRESHOLD = 20.0  # F.softplus's: above it softplus(u) = u
BWD_BLOCK = 128  # steps whose gradients the plain backward computes at once


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


def _scan_bwd_f32(dt, a_log, b_ssm, c_ssm, x, d_skip, dy, dh_last):
    """The base scan's gradients in f32 from f32 dt, x, dy (B, S, DI), B, C
    (B, S, N) and dh_last (B, DI, N) or None: ``(d dt, d a, dB, dC, dx, dD,
    y)`` with ``d a`` the gradient of a = -exp(A_log) and ``y`` the scan's
    output (Σ h C + D x).  The states are recomputed forward and kept, then
    a reverse loop carries dL/dh_t,
    ``G_t = abar_{t+1} G_{t+1} + dy_t C_t`` (``G_{S-1}`` seeded by dh_last),
    and each ``BWD_BLOCK`` steps turn their G and h into the gradients at
    once: only the two recurrences step one at a time."""
    bsz, s, di = dt.shape
    a = -torch.exp(a_log.float())
    d = d_skip.float()
    hs = torch.empty((bsz, s, di, a.shape[1]), dtype=torch.float32, device=dt.device)
    ys = torch.empty_like(dt)
    h = torch.zeros_like(hs[:, 0])
    for t0 in range(0, s, BWD_BLOCK):
        t1 = min(s, t0 + BWD_BLOCK)
        abar = torch.exp(dt[:, t0:t1, :, None] * a)
        bx = (dt[:, t0:t1] * x[:, t0:t1])[..., None] * b_ssm[:, t0:t1, None]
        for i in range(t1 - t0):
            h = abar[:, i] * h + bx[:, i]
            hs[:, t0 + i] = h
        ys[:, t0:t1] = (hs[:, t0:t1] * c_ssm[:, t0:t1, None]).sum(-1) + d * x[:, t0:t1]
    g = torch.zeros_like(h) if dh_last is None else dh_last.float().clone()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b_ssm), torch.empty_like(c_ssm)
    da = torch.zeros_like(a)
    for t0 in range((s - 1) // BWD_BLOCK * BWD_BLOCK, -1, -BWD_BLOCK):
        t1 = min(s, t0 + BWD_BLOCK)
        dt_b, x_b, dy_b = dt[:, t0:t1], x[:, t0:t1], dy[:, t0:t1]
        abar = torch.exp(dt_b[..., None] * a)
        gs = torch.empty_like(abar)
        for i in range(t1 - t0 - 1, -1, -1):
            g = g + dy_b[:, i, :, None] * c_ssm[:, t0 + i, None]
            gs[:, i] = g
            g = g * abar[:, i]
        h_prev = hs[:, max(t0 - 1, 0):t1 - 1]
        if t0 == 0:
            h_prev = torch.cat([torch.zeros_like(hs[:, :1]), h_prev], dim=1)
        q = gs * h_prev * abar
        s_b = (gs * b_ssm[:, t0:t1, None]).sum(-1)
        dc[:, t0:t1] = (dy_b[..., None] * hs[:, t0:t1]).sum(2)
        db[:, t0:t1] = (gs * (dt_b * x_b)[..., None]).sum(2)
        da += (dt_b[..., None] * q).sum((0, 1))
        ddt[:, t0:t1] = x_b * s_b + (q * a).sum(-1)
        dx[:, t0:t1] = dt_b * s_b + d * dy_b
    dd = (dy * x).sum((0, 1))
    return ddt, da, db, dc, dx, dd, ys


def selective_scan_bwd_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, dy, dh_last=None, *,
                           dt_bias=None, z=None):
    """The gradients of :func:`selective_scan_ref` (the output's gradient
    ``dy`` in the output's dtype, the final state's ``dh_last`` (B, DI, N)
    f32 or None for zero), each in its input's dtype: base mode ``(d dt,
    d a_log, dB, dC, dx, dD)``; the fused mode adds ``(d dt_bias, dz)``, and
    its ``d dt`` is the gradient of dt_pre.

    What ``torch.autograd`` of :func:`selective_scan_ref` computes, rounding
    where that rounds: each gradient is cast to its input's dtype where the
    forward cast the input to f32; the fused mode goes back through the
    gate in f32 (dz = dout·y·silu'(z), cast to z's dtype), the cast of dt
    to f32, and the softplus in dt's dtype (``F.softplus``'s backward:
    dout·e/(e+1) with e = exp(u), or dout past the threshold, rounded),
    and d dt_bias sums that over batch and time."""
    if z is not None:
        u = dt + dt_bias
        dt_t = F.softplus(u)
        zf, gf = z.float(), dy.float()
        sig = torch.sigmoid(zf)
        ddt, da, db, dc, dx, dd, y = _scan_bwd_f32(
            dt_t.float(), a_log, b_ssm.float(), c_ssm.float(), x.float(), d_skip,
            gf * F.silu(zf), dh_last)
        dz = (gf * y * (sig * (1 + zf * (1 - sig)))).to(z.dtype)
        uf = u.float()
        e = torch.exp(uf)
        gdt = ddt.to(dt.dtype).float()
        du = torch.where(uf > SOFTPLUS_THRESHOLD, gdt, gdt * e / (e + 1)).to(dt.dtype)
        return (du, da * -torch.exp(a_log.float()), db.to(b_ssm.dtype), dc.to(c_ssm.dtype),
                dx.to(x.dtype), dd, du.float().sum((0, 1)).to(dt_bias.dtype), dz)
    ddt, da, db, dc, dx, dd, _ = _scan_bwd_f32(
        dt.float(), a_log, b_ssm.float(), c_ssm.float(), x.float(), d_skip, dy.float(), dh_last)
    return (ddt.to(dt.dtype), da * -torch.exp(a_log.float()), db.to(b_ssm.dtype),
            dc.to(c_ssm.dtype), dx.to(x.dtype), dd)
