"""Mamba blocks (counterpart of the JAX package's ``models/mamba.py``).

mamba1 (falcon-mamba-7b): a prefill or full-sequence forward runs the
softplus, the recurrence and the gate through the selective-scan kernel's
fused mode (``kernels/mamba_scan``), which also returns the final state the
decode cache keeps; a decode step (one token with a carried state) is one
step of the recurrence in plain PyTorch, as the reference computes it in
jnp.  ``mamba1_scan`` is the plain
recurrence over precomputed ``(abar, bx)``.

mamba2 (zamba2): the SSD chunked algorithm (``ssd_chunked``: intra-chunk
products, an inter-chunk state recurrence over the chunks) and the block
around it (``mamba2_block``), in plain PyTorch, as the reference computes
them in jnp outside any Pallas kernel.  Every product is a pairwise
``torch.einsum``, so no (B, C, Q, Q, H, P) intermediate is ever made.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan_op


# --------------------------------------------------------------- primitives
def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv1d.  x: (B, S, C), w: (C, K), tail: (B, K-1, C).

    Returns (y, new_tail); the taps are summed in f32 in the reference's
    order (tap 0 first, then the bias)."""
    bsz, s, c = x.shape
    k = w.shape[1]
    if tail is None:
        tail = torch.zeros((bsz, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+K-1, C)
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + xp[:, j:j + s, :].float() * w[:, j].float()
    y = y + b.float()
    return y.to(x.dtype), xp[:, s:, :]


# ------------------------------------------------------------------ mamba1
def mamba1_scan(abar, bx):
    """h_t = abar_t * h_{t-1} + bx_t over axis 1, from h = 0.
    (B, S, DI, N) -> (B, S, DI, N); sequential in t."""
    h = torch.zeros_like(bx[:, 0])
    hs = torch.empty_like(bx)
    for t in range(bx.shape[1]):
        h = abar[:, t] * h + bx[:, t]
        hs[:, t] = h
    return hs


def mamba1_block(x, p, cfg, state: Optional[Tuple] = None, backend: str = "kernel"):
    """x: (B, S, D).  state: (ssm_h (B, DI, N) f32, conv_tail) for decode.

    Returns (out, (new_h, new_tail)).  The scan sees dt and x in f32, so y
    stays f32 up to the gate, as in the reference.  A prefill runs the
    softplus, the scan and the gate in the scan kernel's fused mode, which
    reads z in place as the second half of ``xz``."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    xz = torch.matmul(x, p["in_proj"])  # (B, S, 2*DI)
    xpart, z = xz.chunk(2, dim=-1)
    conv_tail = state[1] if state is not None else None
    xpart, new_tail = _causal_conv(xpart, p["conv_w"], p["conv_b"], conv_tail)
    xpart = F.silu(xpart)

    proj = torch.matmul(xpart, p["x_proj"])  # (B, S, dtr + 2N)
    dtr = cfg.dtr()
    dt_raw, b_ssm, c_ssm = torch.split(proj, [dtr, n, n], dim=-1)
    dt_pre = torch.matmul(dt_raw, p["dt_proj"])  # (B, S, DI)

    if state is not None and s == 1:
        dt = F.softplus(dt_pre + p["dt_bias"])
        a = -torch.exp(p["A_log"].float())  # (DI, N)
        dt0 = dt[:, 0].float()
        abar = torch.exp(dt0[..., None] * a[None])  # (B, DI, N)
        bx = dt0[..., None] * b_ssm[:, 0].float()[:, None, :] * xpart[:, 0].float()[..., None]
        h = abar * state[0] + bx
        y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0].float())[:, None]
        y = y + p["D_skip"].float() * xpart.float()
        y = (y * F.silu(z.float())).to(x.dtype)
        new_h = h
    else:
        y, new_h = selective_scan_op(
            dt_pre, p["A_log"], b_ssm.contiguous(), c_ssm.contiguous(), xpart, p["D_skip"],
            dt_bias=p["dt_bias"], z=z, backend=backend,
        )
    out = torch.matmul(y, p["out_proj"])
    return out, (new_h, new_tail)


# ------------------------------------------------------------------ mamba2
def ssd_chunked(xh, dt, a_log, b_ssm, c_ssm, chunk: int, init_state=None):
    """Mamba2 SSD forward, in f32.

    xh:    (B, S, H, P)   value heads
    dt:    (B, S, H)      positive step sizes (already softplus'd)
    a_log: (H,)           per-head log decay
    b_ssm: (B, S, N)      input projection (single group)
    c_ssm: (B, S, N)      output projection
    ``chunk`` divides S.  The recurrence starts from ``init_state`` (B, H,
    P, N), or from zero.  Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    bsz, s, h, p_dim = xh.shape
    n = b_ssm.shape[-1]
    nc, q = s // chunk, chunk
    f32 = torch.float32

    da = dt.float() * (-torch.exp(a_log.float()))[None, None]  # (B, S, H) <= 0
    da = da.reshape(bsz, nc, q, h)
    xc = xh.reshape(bsz, nc, q, h, p_dim).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_ssm.reshape(bsz, nc, q, n).float()
    cc = c_ssm.reshape(bsz, nc, q, n).float()

    cum = torch.cumsum(da, dim=2)  # (B, C, Q, H) cumulative log decay
    total = cum[:, :, -1]  # (B, C, H)

    # intra-chunk: Y[t] = sum_{tau<=t} exp(cum_t - cum_tau) (C_t . B_tau) dt_tau x_tau.
    # Above the diagonal exp() may overflow to inf: select, never multiply
    # by a 0/1 mask (inf * 0 is NaN).  The select comes before exp too (the
    # reference's only after): exp(-inf) is the same 0 there, and exp's
    # gradient 0 * 0 where grad * inf would be NaN.  The select after exp
    # keeps exp's output, which its gradient reads, out of the in-place
    # products below.
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(tri, cum[:, :, :, None] - cum[:, :, None, :], -torch.inf))
    decay = torch.where(tri, decay, 0.0)  # (B, C, Qt, Qtau, H)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)  # (B, C, Qt, Qtau)
    w = decay.mul_(cb[..., None]).mul_(dtc[:, :, None])  # (B, C, Qt, Qtau, H)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", w, xc)
    del decay, w

    # chunk states: S_c = sum_tau exp(total - cum_tau) B_tau (dt_tau x_tau)
    state_decay = torch.exp(total[:, :, None] - cum)  # (B, C, Q, H)
    xw = xc * (state_decay * dtc)[..., None]  # (B, C, Q, H, P)
    s_chunk = torch.einsum("bckhp,bckn->bchpn", xw, bc)
    del xw

    # inter-chunk recurrence over C: the state entering each chunk
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p_dim, n), dtype=f32, device=xh.device))
    s_prevs = torch.empty((bsz, nc, h, p_dim, n), dtype=f32, device=xh.device)
    for c in range(nc):
        s_prevs[:, c] = state
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_chunk[:, c]

    # off-diagonal: Y_off[t] = exp(cum_t) C_t . S_prev
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc, s_prevs) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p_dim)
    return y, state


def mamba2_block(x, p, cfg, state: Optional[Tuple] = None):
    """Mamba2 block (zamba2).  x: (B, S, D); state: (ssm (B, H, P, N) f32,
    conv_tail (B, d_conv - 1, DI + 2N)).  Returns (out, (final, new_tail)).

    One token with a state is one step of the recurrence; otherwise the
    chunked SSD, in chunks of min(128, S) where that divides S, else one
    chunk of S (the reference's rule), started from ``state[0]`` where a
    state is given (unlike ``mamba1_block``, which starts from zero: the
    reference differs there too).  The gated RMSNorm, norm(y * silu(z)),
    is computed inline in f32 (eps 1e-6) and cast after the scale, as the
    reference does, not through the RMSNorm kernel."""
    b, s, _ = x.shape
    di, n = cfg.d_inner(), cfg.ssm_state
    hp = cfg.ssm_head_dim
    nh = di // hp
    zxbcdt = torch.matmul(x, p["in_proj"])  # (B, S, 2*DI + 2N + H)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    conv_tail = state[1] if state is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xbc = F.silu(xbc)
    xpart, b_ssm, c_ssm = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw + p["dt_bias"])  # (B, S, H)

    xh = xpart.reshape(b, s, nh, hp)
    d_skip = p["D_skip"].float()
    if state is not None and s == 1:
        dt0, x0 = dt[:, 0].float(), xh[:, 0].float()
        da = torch.exp(dt0 * (-torch.exp(p["A_log"].float()))[None])  # (B, H)
        upd = (dt0[:, :, None] * x0)[..., None] * b_ssm[:, 0].float()[:, None, None, :]
        final = state[0] * da[:, :, None, None] + upd  # (B, H, P, N)
        yh = torch.einsum("bhpn,bn->bhp", final, c_ssm[:, 0].float())
        yh = yh + d_skip[None, :, None] * x0
        y = yh.reshape(b, 1, di)
    else:
        chunk = min(128, s) if s % min(128, s) == 0 else s
        y4, final = ssd_chunked(xh, dt, p["A_log"], b_ssm, c_ssm, chunk,
                                init_state=state[0] if state is not None else None)
        y4 = y4 + d_skip[None, None, :, None] * xh.float()
        y = y4.reshape(b, s, di)
    # gated RMSNorm (mamba2 style): norm(y * silu(z))
    g = y * F.silu(z.float())
    var = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = torch.matmul(g.to(x.dtype), p["out_proj"])
    return out, (final, new_tail)
