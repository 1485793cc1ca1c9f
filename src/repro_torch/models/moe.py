"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
the JAX package's ``models/moe.py``).

Tokens are routed top-k in f32, each assignment ranked within its expert in
a stable sort by expert id, packed into an (E, C, D) capacity buffer (an
assignment ranked past the capacity C is dropped), run through a batched
SwiGLU and combined back weighted by the renormalised router probabilities.
With ``cfg.moe_groups`` = G the tokens are split into G groups, each ranked
against its own capacity (the reference's grouped dispatch): G changes which
assignments are dropped, so it changes the output.  arctic-480b adds a dense
residual SwiGLU in parallel (``dense_residual``).

The ranking follows the reference exactly: ``jnp.argsort`` is stable, so the
sort here is ``torch.argsort(stable=True)``, and an overloaded expert keeps
its assignments in (token, rank) order.  The combine adds each token's k
contributions in ascending expert order in ``x.dtype`` starting from zeros,
as the reference's sequential scatter-add meets them; it uses no atomics,
so two calls give the same bits.  The expert products are batched matrix
products, as the reference computes them in ``jnp.einsum``: no Pallas
kernel stands behind this module.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp_block


def _count(idx, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in the int64 ``idx`` (1-D): the
    counts ``torch.bincount(idx, minlength=n)`` gives, by an integer
    scatter-add of ones (exact), which the ``meta`` device also runs (the
    dry run's)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (per group when grouped):
    ``capacity_factor * tokens * k / E``, at least 1, rounded up to 8."""
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) or 1
    return -(-cap // 8) * 8


def n_groups(cfg, t: int) -> int:
    """The dispatcher's choice for ``t`` tokens: ``cfg.moe_groups`` groups
    where they tile the tokens, else 1 (the flat path; a decode step of a
    few tokens takes it)."""
    g = cfg.moe_groups
    return g if g and t >= g and t % g == 0 else 1


def moe_route(x, p, cfg) -> Dict[str, Any]:
    """The routing of ``x`` (B, S, D) alone.  Returns ``gate_all`` (T, E),
    the softmax of the f32 router logits; ``expert_idx`` and ``gates``
    (T, k), the top-k experts by probability and their renormalised gates;
    ``keep`` (T, k), whether each assignment got a slot; ``dest`` (T, k),
    its slot in its group's (E * cap + 1)-row buffer, ``E * cap`` (the drop
    slot) where dropped; ``cap``, the slots per expert of a group; and
    ``groups`` (1: the flat path)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    g = n_groups(cfg, t)
    tg = t // g
    cap = capacity(cfg, tg)
    logits = x.reshape(t, -1).float() @ p["router"].float()
    gate_all = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(gate_all, k, dim=-1, sorted=True)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # rank each assignment within its expert, group by group, in the stable
    # sort's order: (token, rank) order within one expert
    ge = expert_idx.reshape(g, tg * k)
    order = torch.argsort(ge, dim=1, stable=True)
    se = ge.gather(1, order)
    offset = torch.arange(g, device=x.device)[:, None] * e
    counts = _count((ge + offset).reshape(-1), g * e).reshape(g, e)
    starts = counts.cumsum(1) - counts
    pos = torch.arange(tg * k, device=x.device)[None, :] - starts.gather(1, se)
    keep_s = pos < cap
    dest_s = torch.where(keep_s, se * cap + pos, e * cap)
    # back to assignment order
    keep = torch.empty_like(keep_s).scatter_(1, order, keep_s)
    dest = torch.empty_like(dest_s).scatter_(1, order, dest_s)
    return {"gate_all": gate_all, "expert_idx": expert_idx, "gates": gates,
            "keep": keep.reshape(t, k), "dest": dest.reshape(t, k), "cap": cap,
            "groups": g}


def aux_loss(route, cfg) -> torch.Tensor:
    """The switch-style load-balance loss, E * sum(mean gate * k x the share
    of assignments), the same for both paths."""
    e, k = cfg.n_experts, cfg.top_k
    flat = route["expert_idx"].reshape(-1)
    me = route["gate_all"].mean(dim=0)
    ce = _count(flat, e).float() / flat.numel() * k
    return e * torch.sum(me * ce)


def expert_outputs(x, p, cfg, route) -> torch.Tensor:
    """Each assignment's weighted expert output, (T, k, D) in ``x.dtype``:
    the tokens scattered into the capacity buffer, the batched SwiGLU, each
    kept assignment's row gathered back (zero where dropped), weighted by
    its gate in f32 and cast."""
    t, d = x.shape[0] * x.shape[1], x.shape[-1]
    e, k = cfg.n_experts, cfg.top_k
    g, cap = route["groups"], route["cap"]
    # one (E, G * cap) buffer for every group: group j's slot (expert i,
    # position q) is row i * G * cap + j * cap + q; the last row takes drops
    dest, keep = route["dest"], route["keep"]
    group = torch.arange(t, device=x.device)[:, None] // (t // g)
    row = torch.where(keep, (dest // cap) * g * cap + group * cap + dest % cap, e * g * cap)
    tok = torch.arange(t, device=x.device)[:, None].expand(t, k)
    buf = torch.zeros((e * g * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[row.reshape(-1)] = x.reshape(t, d)[tok.reshape(-1)]
    disp = buf[:-1].view(e, g * cap, d)

    h = F.silu(torch.bmm(disp, p["w1"])) * torch.bmm(disp, p["w3"])
    expert_out = torch.bmm(h, p["w2"]).reshape(e * g * cap, d)
    got = expert_out[row.clamp(max=e * g * cap - 1)]  # (T, k, D)
    got = torch.where(keep[..., None], got, torch.zeros((), dtype=x.dtype, device=x.device))
    return (got.float() * route["gates"][..., None]).to(x.dtype)


def combine(contrib, expert_idx) -> torch.Tensor:
    """Each token's k contributions (T, k, D) summed in ascending expert
    order, in their dtype, from zeros: (T, D)."""
    t, k, d = contrib.shape
    by_expert = torch.argsort(expert_idx, dim=1)
    contrib = contrib.gather(1, by_expert[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for r in range(k):
        out = out + contrib[:, r]
    return out


def moe_ffn(x, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux).  p: router (D, E) f32, w1 / w3
    (E, D, F), w2 (E, F, D), and ``dense`` (a SwiGLU) where
    ``cfg.dense_residual``."""
    b, s, d = x.shape
    route = moe_route(x, p, cfg)
    out = combine(expert_outputs(x, p, cfg, route), route["expert_idx"])
    if cfg.dense_residual:
        out = out + mlp_block(x.reshape(b * s, d), p["dense"], kind="swiglu")
    return out.reshape(b, s, d), aux_loss(route, cfg)
