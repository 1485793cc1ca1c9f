"""Public wrapper: backend-selected attention (CUDA kernel or plain version).

Also ``chunked_attention``, the counterpart of the reference's XLA-native
online-softmax attention over key chunks: plain PyTorch, as the reference's
is XLA and no Pallas kernel.  The model's attention without a cache takes
it where ``cfg.attn_impl == "chunked"`` (a lever no configuration sets by
default; ``launch/hillclimb.py`` tries it).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal=True, backend: str = "kernel"):
    """``backend="kernel"`` goes through :func:`kernel.flash_attention` (the
    CUDA kernel on the card, its plain version for a CPU tensor); ``"ref"``
    runs the plain version wherever the tensors lie."""
    if backend == "kernel":
        return flash_attention(q, k, v, causal=causal)
    if backend == "ref":
        return attention_ref(q, k, v, causal=causal)
    raise ValueError(f"unknown backend {backend!r}")


def chunked_attention(q, k, v, *, causal=True, blk_k: int = 512):
    """Online-softmax attention over key chunks of ``min(blk_k, T)`` keys;
    a T that the chunk does not divide raises, as the reference's reshape
    into T // blk_k chunks does.  q: (B, S, Hq, hd); k/v: (B, T, Hkv, hd)
    -> (B, S, Hq, hd) in q's dtype; never makes the (S, T) scores.  The
    queries sit at positions 0..S-1; with ``causal`` the loop stops at the
    first chunk past the last query, as the reference's unrolled loop does.
    The reference's ``q_offset``, ``q_offset_static`` and ``unroll`` knobs
    are not carried: nothing sets them."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    blk_k = min(blk_k, t)
    if t % blk_k:
        raise ValueError(f"{t} keys do not split into chunks of {blk_k}")
    n_k = t // blk_k
    scale = 1.0 / math.sqrt(hd)

    qf = q.reshape(b, s, hkv, g, hd).float()
    kc = k.reshape(b, n_k, blk_k, hkv, hd)
    vc = v.reshape(b, n_k, blk_k, hkv, hd)
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, hkv, g, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, hd), dtype=torch.float32, device=q.device)
    for ki in range(n_k):
        if causal and ki * blk_k > s - 1:
            break  # fully masked chunks contribute nothing
        sres = torch.einsum("bskgd,btkd->bkgst", qf, kc[:, ki].float()) * scale
        if causal:
            kpos = ki * blk_k + torch.arange(blk_k, device=q.device)
            sres = sres.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        m_new = torch.maximum(m, sres.amax(-1))
        p = torch.exp(sres - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vc[:, ki].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd).to(q.dtype)
