"""Gradient compression for the cross-pod data-parallel axis (counterpart
of the JAX package's ``distributed/compression.py``), in torch.

Two composable schemes:

  * error-feedback top-k sparsification (memory = one residual per param):
    the residual carries the un-transmitted mass into the next step, which
    preserves convergence (Stich et al.),
  * int8 linear quantization with a per-tensor scale (4x over f32, 2x bf16).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes equal the reference's bit for bit.  ``torch.topk`` and
``lax.top_k`` may order (and so pick among) equal magnitudes differently:
on distinct magnitudes both keep the same index set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass
class CompressionState:
    residual: Any  # a tree shaped as the grads


def init_compression(params) -> CompressionState:
    return CompressionState(
        residual=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params))


# --------------------------------------------------------------------- top-k
def compress_topk(g: torch.Tensor, frac: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-|frac| entries by magnitude.  Returns (values, flat_idx)."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def decompress_topk(vals, idx, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def ef_compress_grads(grads, state: CompressionState, frac: float = 0.01):
    """Error-feedback top-k over a gradient tree.

    Returns (compressed_grads_dense, new_state).  The dense reconstruction is
    what enters the cross-pod all-reduce; the residual keeps whatever was
    dropped."""

    def one(g, r):
        acc = g.to(torch.float32) + r
        vals, idx = compress_topk(acc, frac)
        sent = decompress_topk(vals, idx, acc.shape)
        return sent.to(g.dtype), acc - sent

    out = [one(g, r) for g, r in zip(tree_flatten(grads), tree_flatten(state.residual))]
    sent = tree_unflatten(grads, [o[0] for o in out])
    resid = tree_unflatten(grads, [o[1] for o in out])
    return sent, CompressionState(residual=resid)


# ---------------------------------------------------------------------- int8
def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
