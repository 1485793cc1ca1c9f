"""Per-arch tuned levers (counterpart of the JAX package's
``launch/tuned.py``): the reference's whole ``TUNED`` table, applied by the
serving and training launchers unless ``--no-tuned``.

Of its levers only ``moe_groups=16`` (the two MoE archs) changes the math
on one card: the grouped dispatch gives each of 16 token groups its own
expert capacity (``models/moe.py``).  The others, context-parallel
attention (``attn_seq_shard``) and the sequence-parallel residual
(``seq_parallel_resid``), are sharding constraints of the reference's mesh;
the port carries them in the configuration, where they are inert
(``models/config.py``).  The key is ``cfg.name``, as in the reference, so
the reduced ``*-smoke`` configurations get no tuning.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

# context-parallel attention + sequence-parallel residual, as the reference
# tunes every attention-bearing arch
_ATTN_TUNING = dict(attn_seq_shard=True, seq_parallel_resid=True)

TUNED = {
    "llama-3.2-vision-11b": _ATTN_TUNING,
    "zamba2-7b": _ATTN_TUNING,
    "smollm-135m": _ATTN_TUNING,
    "qwen2-1.5b": _ATTN_TUNING,
    "olmo-1b": _ATTN_TUNING,
    "deepseek-coder-33b": _ATTN_TUNING,
    "musicgen-large": _ATTN_TUNING,
    "arctic-480b": dict(moe_groups=16, **_ATTN_TUNING),
    "dbrx-132b": dict(moe_groups=16, **_ATTN_TUNING),
    "falcon-mamba-7b": dict(seq_parallel_resid=True),
}


def apply_tuning(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, **TUNED.get(cfg.name, {}))
