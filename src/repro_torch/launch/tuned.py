"""Per-arch tuning the serving launcher applies (counterpart of the JAX
package's ``launch/tuned.py``).

Only the lever that changes the math is carried: ``moe_groups=16`` for the
two MoE archs, whose grouped dispatch gives each of 16 token groups its own
expert capacity (``models/moe.py``).  The reference's other levers
(context-parallel attention, the sequence-parallel residual) shard across
devices and mean nothing on one card; so ``zamba2-7b``, which the reference
tunes with those sharding levers alone, gets nothing here, as do the dense,
vlm, audio and ssm archs.  The key is ``cfg.name``, as in the reference, so
the reduced ``*-smoke`` configurations get no tuning.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

TUNED = {
    "arctic-480b": dict(moe_groups=16),
    "dbrx-132b": dict(moe_groups=16),
}


def apply_tuning(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, **TUNED.get(cfg.name, {}))
