"""Mamba blocks (counterpart of the JAX package's ``models/mamba.py``).

mamba1 (falcon-mamba-7b): a prefill or full-sequence forward runs the
softplus, the recurrence and the gate through the selective-scan kernel's
fused mode (``kernels/mamba_scan``), which also returns the final state the
decode cache keeps; a decode step (one token with a carried state) is one
step of the recurrence in plain PyTorch, as the reference computes it in
jnp.  ``mamba1_scan`` is the plain
recurrence over precomputed ``(abar, bx)``.  mamba2 (zamba2's SSD) waits for
the hybrid slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan_op

_SLICE_HYBRID = "the hybrid slice"


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
def ssd_chunked(*args, **kwargs):
    raise NotImplementedError(f"mamba2's SSD waits for {_SLICE_HYBRID}")


def mamba2_block(*args, **kwargs):
    raise NotImplementedError(f"mamba2 waits for {_SLICE_HYBRID}")
