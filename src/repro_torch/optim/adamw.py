"""AdamW (counterpart of the JAX package's ``optim/adamw.py``), with the
reference's math, not ``torch.optim.AdamW``'s: weight decay is added into
the step (``mhat / (sqrt(vhat) + eps) + wd * p``), where PyTorch's AdamW
first scales the parameter by ``1 - lr * wd``; the gradients are clipped to
a global norm taken over every leaf in f32; the schedule is read at the
count before its increment; the bias corrections ``1 - b ** count`` are
computed on f32 tensors.

The state is ``{"m", "v", "count"}``: moments shaped as the parameters in
``state_dtype`` and ``count`` a 0-d int32, so its leaves flatten in the
reference's order.  The update math runs in f32 whatever the storage dtype.
:func:`adamw_update` returns new tensors and changes none it is given, as
the reference's pure function does (autograd may still hold the old ones);
with ``donate`` it writes the same bits into the parameters and moments it
is given, so a state the caller owns is not held twice (a training loop's:
dbrx-132b's one layer, 4.49 B parameters, takes 45 GB of bf16 weights and
f32 moments, and two of them do not fit one 80 GB card).  Either way a leaf
is updated in slices of ``_CHUNK`` elements, which bounds the f32
temporaries; the math is elementwise, so the slices change no bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CHUNK = 1 << 26  # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = _DTYPES[cfg.state_dtype]
    leaves = tree_flatten(params)
    if not leaves:
        raise ValueError("no parameters")
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac * lr`` over ``decay_steps``; ``step`` a tensor, the
    result an f32 0-d tensor on its device."""
    step = step.to(torch.float32)
    warm = cfg.lr * (step + 1.0) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_update(params, grads, state, cfg: AdamWConfig, donate: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step: ``(new_params, new_state, {"grad_norm", "lr"})``, the
    metrics f32 0-d tensors (no host sync).  ``donate``: the new values are
    written into ``params`` and ``state``'s moments (contiguous tensors),
    which the returned trees hold."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    lr = lr_schedule(cfg, state["count"])

    flat_g = tree_flatten(grads)
    gsq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in flat_g)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)

    dt = _DTYPES[cfg.state_dtype]
    one = torch.ones((), dtype=torch.float32, device=cf.device)
    bc1 = 1 - torch.pow(one * cfg.b1, cf)
    bc2 = 1 - torch.pow(one * cfg.b2, cf)

    def upd(p, g, m, v, new_p, new_m, new_v):
        gf = g.to(torch.float32) * scale
        mf = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(gf)
        mhat = mf / bc1
        vhat = vf / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p.copy_(p.to(torch.float32) - lr * step_)  # rounded as .to(p.dtype) rounds
        new_m.copy_(mf)
        new_v.copy_(vf)

    flat_p, flat_m, flat_v = (tree_flatten(t) for t in (params, state["m"], state["v"]))
    if donate:
        out_p, out_m, out_v = flat_p, flat_m, flat_v
    else:
        new = lambda p, dtype: torch.empty(p.shape, dtype=dtype, device=p.device)
        out_p = [new(p, p.dtype) for p in flat_p]
        out_m, out_v = ([new(p, dt) for p in flat_p] for _ in range(2))
    for leaf in zip(flat_p, flat_g, flat_m, flat_v, out_p, out_m, out_v):
        ins = [t.reshape(-1) for t in leaf[:4]]
        outs = [t.view(-1) for t in leaf[4:]]
        for i in range(0, ins[0].numel(), _CHUNK):
            upd(*(t[i:i + _CHUNK] for t in ins + outs))
    new_params = tree_unflatten(params, out_p)
    new_m = tree_unflatten(params, out_m)
    new_v = tree_unflatten(params, out_v)
    return new_params, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
