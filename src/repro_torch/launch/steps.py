"""Step functions the launchers run (counterpart of the JAX package's
``launch/steps.py``), plain functions over the port's model:

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  prefill_step(params, batch)        -> (last_logits, cache)
  serve_step(params, cache, batch)   -> ({"logits", "next_token"}, cache)
  quantum_step(params, cache, tok)   -> ({"tokens", "next_token"}, cache)

``window`` (a keyword, as the reference's launcher passes it) > 0 makes the
decode steps rolling-window steps (the model's ``decode_step(window=)``).
PyTorch runs eagerly, so nothing is traced or compiled.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, loss_fn, prefill
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_flatten, tree_unflatten


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, backend: str = "kernel",
                    donate: bool = False):
    """One training step: the loss and every parameter's gradient
    (``torch.autograd.grad``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives), then :func:`adamw_update`.  ``batch`` holds tensors
    on the parameters' device; ``metrics`` are 0-d tensors: ``loss``,
    ``grad_norm`` and ``lr``.  The given params and state are not changed,
    unless ``donate``: then the new values are written into them (the
    same bits), and the returned trees hold them."""

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_flatten(params)]
        loss = loss_fn(tree_unflatten(params, leaves), cfg, batch, backend=backend)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        new_params, new_opt, metrics = adamw_update(
            params, tree_unflatten(params, list(grads)), opt_state, opt_cfg, donate=donate)
        return new_params, new_opt, dict(metrics, loss=loss.detach())

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int, backend: str = "kernel"):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_len, backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig, backend: str = "kernel", *, window: int = 0):
    def serve_step(params, cache, batch):
        logits, new_cache = decode_step(params, cfg, cache, batch, backend=backend,
                                        window=window)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return {"logits": logits, "next_token": next_token}, new_cache

    return serve_step


def make_quantum_step(cfg: ModelConfig, quantum: int = 8, backend: str = "kernel", *,
                      window: int = 0):
    """Greedy-decode ``quantum`` tokens per call: ``tok`` is (B, 1), the
    last token already emitted; returns ``tokens`` (B, quantum), where
    ``tokens[:, 0]`` is the token decoded from ``tok``, and ``next_token``
    (B, 1), the last of them."""

    def quantum_step(params, cache, tok):
        toks = []
        for _ in range(quantum):
            logits, cache = decode_step(params, cfg, cache, {"tokens": tok},
                                        backend=backend, window=window)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok)
        return {"tokens": torch.cat(toks, dim=1), "next_token": tok}, cache

    return quantum_step
