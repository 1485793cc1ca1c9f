"""Step functions the serving launcher runs (counterpart of the JAX
package's ``launch/steps.py``), plain functions over the port's model:

  prefill_step(params, batch)        -> (last_logits, cache)
  serve_step(params, cache, batch)   -> ({"logits", "next_token"}, cache)
  quantum_step(params, cache, tok)   -> ({"tokens", "next_token"}, cache)

``window`` (a keyword, as the reference's launcher passes it) > 0 makes the
decode steps rolling-window steps (the model's ``decode_step(window=)``).  PyTorch runs eagerly, so nothing is traced or
compiled.  ``make_train_step`` waits for the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill


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
