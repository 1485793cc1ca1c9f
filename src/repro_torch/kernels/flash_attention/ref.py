"""Plain PyTorch versions of flash attention (the forward is the JAX
package's ``kernels/flash_attention/ref.py``, same signature; the row
log-sum-exp and the backward are the port's own): the CPU path of the
wrapper and the card's reference."""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, S, Hq, hd); k/v: (B, T, Hkv, hd) -> (B, S, Hq, hd) in q's dtype.

    f32 scores scaled by 1/sqrt(hd); with ``causal`` key t is visible to
    query s iff t <= s, positions counted from 0 on both sides."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, s, hkv, g, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    if causal:
        pos_t = torch.arange(t, device=q.device)
        pos_s = torch.arange(s, device=q.device)
        mask = pos_t[None, :] <= pos_s[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def _scores(q, k, causal):
    """(B, Hkv, G, S, T) f32 scaled scores, -1e30 where masked."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.reshape(b, s, hkv, hq // hkv, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    return scores


def attention_lse_ref(q, k, *, causal: bool = True):
    """The rows' log-sum-exp of the scaled scores, (B, Hq, S) f32: what the
    forward kernel writes beside its output for the backward."""
    b, s, hq, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(b, hq, s)


def attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """The gradients of :func:`attention_ref` from its output ``o``, the
    rows' log-sum-exp ``lse`` (B, Hq, S) and the output's gradient ``do``:
    ``(dq, dk, dv)`` in the inputs' dtypes, computed in f32.  P = exp(scaled
    scores - lse) (0 where masked), D = rowsum(do o), dS = P (do v^T - D),
    dq = scale dS k, dk = scale dS^T q and dv = P^T do, each summed over the
    query heads of a kv head's group."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(_scores(q, k, causal) - lse.reshape(b, hkv, g, s, 1))
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        p = p * mask
    dof = do.reshape(b, s, hkv, g, hd).float()
    of = o.reshape(b, s, hkv, g, hd).float()
    dsum = (dof * of).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, S)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.reshape(b, s, hkv, g, hd).float()) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return (dq.reshape(b, s, hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
