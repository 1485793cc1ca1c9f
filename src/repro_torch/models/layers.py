"""Shared layers: norms, rotary embeddings, attention with a KV cache, MLPs.

Counterpart of the JAX package's ``models/layers.py``.  Where the reference
computes a function in jnp that one of its Pallas kernels also computes, the
port calls its hand-written kernel through the kernel's op: ``rmsnorm`` goes
through the RMSNorm kernel, and prefill or forward attention (queries from
position 0 over the prompt's own keys, or a cross-attention's queries over
every key of its source) through the flash-attention kernel.
``backend="ref"`` runs the kernels' plain versions instead.  Decode
attention (one query against the cache) and a sliding-window attention
(``window`` > 0: neither the Pallas kernel nor the flash kernel has a
window) stay plain PyTorch, as the reference computes them in jnp.  With
``cfg.attn_impl == "chunked"`` the attention without a cache (the training
forward) is the reference's online softmax over key chunks,
``chunked_attention``, in plain PyTorch as the reference's is XLA.  Matrix
products are ``torch.matmul``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import attention, chunked_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op


# ------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps: float = 1e-6, backend: str = "kernel"):
    return rmsnorm_op(x, scale, backend=backend, eps=eps)


def layernorm_np(x, _scale_unused=None, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x, scale, backend: str = "kernel"):
    if kind == "rmsnorm":
        return rmsnorm(x, scale, backend=backend)
    return layernorm_np(x)


# -------------------------------------------------------------------- rope
@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary inverse frequencies, computed in float64 numpy and cast to
    f32 as the reference's jnp does; made once per device, since a copy to
    the card each call would stall the host on the queued work."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope_freqs(head_dim: int, theta: float, positions):
    """positions: int[...]; returns (cos, sin) of shape positions.shape + (hd/2,)."""
    ang = positions[..., None].float() * _inv_freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2).  Half-split
    rotation (the two halves of the head, not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:  # (S, hd/2): broadcast over batch + heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, hd/2): broadcast over heads
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def gqa_attention(q, k, v, causal: bool = True, q_offset: int = 0, window: int = 0):
    """Grouped-query attention in plain PyTorch, f32 softmax, optional
    causal and sliding-window masks.  q: (B, S, Hq, hd); k/v: (B, T, Hkv,
    hd); q[0] sits at absolute position ``q_offset`` (decode: the cache
    length); ``window`` > 0 hides keys at or before query position -
    ``window``."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.reshape(b, s, hkv, group, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    if causal:
        scores = scores.masked_fill(kpos > qpos, -1e30)
    if window:
        scores = scores.masked_fill(kpos <= qpos - window, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def cross_kv(src, p, cfg):
    """Cross-attention's keys and values: ``src`` (B, T, D) through ``wk`` /
    ``wv``, with no bias and no rope (the reference's ``kv_override``
    branch)."""
    b = src.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.hd()
    k = torch.matmul(src, p["wk"]).reshape(b, -1, hkv, hd)
    v = torch.matmul(src, p["wv"]).reshape(b, -1, hkv, hd)
    return k, v


def attention_block(
    x,
    p,  # params: wq, wk, wv, wo (+ bq, bk, bv if qkv_bias)
    cfg,
    positions,
    kv_cache: Optional[Tuple] = None,  # (k_cache, v_cache, length)
    kv_override=None,  # cross-attention: source (B, T, D), or its (k, v)
    backend: str = "kernel",
    window: int = 0,  # sliding window over the keys, 0 = full
):
    """Self- or cross-attention, optionally over a KV cache.

    Returns ``(out, new_kv_cache_entry or None)``.  With a cache, the new
    keys and values are written into ``k_cache`` / ``v_cache`` IN PLACE at
    ``[length, length + s)`` (the reference returns updated copies; writing
    in place keeps one cache on the card).  A prefill (``length == 0``)
    attends over the prompt's own keys through the flash-attention kernel,
    which the reference's masked attention over the zero-initialised cache
    equals; a decode step (``length > 0``) attends over the cache in plain
    PyTorch.  Cross-attention (``kv_override``: the source, or the pair
    :func:`cross_kv` makes of it) puts the bias and the rope on the queries
    only and attends over every key, through the flash kernel's non-causal
    mode.  ``window`` > 0 (self-attention only) masks keys more than
    ``window`` - 1 positions back, in plain PyTorch over the cache (or the
    prompt's own keys without one).  ``cfg.attn_impl == "chunked"`` sends
    the self-attention without a cache through :func:`chunked_attention`
    over ``cfg.attn_chunk`` keys a chunk, whatever ``window`` is, as the
    reference's branch does.
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = torch.matmul(x, p["wq"]).reshape(b, s, hq, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, hq, hd)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    if kv_override is not None:
        k, v = kv_override if isinstance(kv_override, tuple) else cross_kv(kv_override, p, cfg)
        out = attention(q, k, v, causal=False, backend=backend)
        return torch.matmul(out.reshape(b, s, hq * hd), p["wo"]), None
    k = torch.matmul(x, p["wk"]).reshape(b, s, hkv, hd)
    v = torch.matmul(x, p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, hkv, hd)
        v = v + p["bv"].reshape(1, 1, hkv, hd)
    k = apply_rope(k, cos, sin)

    new_cache = None
    length = 0
    if kv_cache is not None:
        k_cache, v_cache, length = kv_cache
        k = k.to(k_cache.dtype)
        v = v.to(v_cache.dtype)
        k_cache[:, length:length + s] = k
        v_cache[:, length:length + s] = v
        new_cache = (k_cache, v_cache, length + s)
    if kv_cache is None and cfg.attn_impl == "chunked":
        out = chunked_attention(q, k, v, causal=True, blk_k=cfg.attn_chunk)
    elif length == 0 and not window:
        out = attention(q, k, v, causal=True, backend=backend)
    elif kv_cache is None:
        out = gqa_attention(q, k, v, causal=True, window=window)
    else:
        out = gqa_attention(q, k_cache, v_cache, causal=True, q_offset=length, window=window)
    out = torch.matmul(out.reshape(b, s, hq * hd), p["wo"])
    return out, new_cache


# -------------------------------------------------------------------- MLPs
def mlp_block(x, p, kind: str = "swiglu"):
    if kind == "swiglu":
        h = F.silu(torch.matmul(x, p["w1"])) * torch.matmul(x, p["w3"])
        return torch.matmul(h, p["w2"])
    h = F.gelu(torch.matmul(x, p["w1"]), approximate="tanh")
    return torch.matmul(h, p["w2"])
