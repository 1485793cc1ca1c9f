"""Plain PyTorch version of flash attention (the JAX package's
``kernels/flash_attention/ref.py``, same signature): the CPU path of the
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
