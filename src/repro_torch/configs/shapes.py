"""Assigned input shapes and per-(arch x shape) input specs (counterpart of
the JAX package's ``configs/shapes.py``).

Four shapes per LM architecture:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   ctx 32,768  global_batch 128   -> serve_step (1 new token)
  long_500k    ctx 524,288 global_batch 1     -> serve_step; SSM/hybrid only,
               over a 4,096-token rolling attention window

``input_specs`` returns stand-ins that allocate nothing: tensors on the
``meta`` device for everything a step function consumes -- the batch and
(for decode) the KV/SSM cache, made by the model's own ``init_cache`` on
that device (the reference's ``jax.eval_shape``).  The cache's ``len`` is
the int the port's caches carry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    window: int = 0  # rolling attention window for long-context decode


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode", window=4_096),
}

# archs allowed to run long_500k (sub-quadratic decode state)
LONG_CONTEXT_ARCHS = ("zamba2-7b", "falcon-mamba-7b")


def supports(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def _batch_specs(cfg: ModelConfig, b: int, s: int, with_labels: bool):
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    specs: Dict[str, torch.Tensor] = {}
    if cfg.embedding_inputs:
        specs["embeddings"] = spec((b, s, cfg.d_model), cfg.act_dtype())
    else:
        specs["tokens"] = spec((b, s), torch.int32)
    if with_labels:
        specs["labels"] = spec((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["image_embeddings"] = spec((b, cfg.n_img_tokens, cfg.d_model), cfg.act_dtype())
    return specs


def input_specs(cfg: ModelConfig, shape) -> Dict:
    """Meta-tensor stand-ins for the step function of (arch, shape):
    ``shape`` a name of :data:`SHAPES` or a :class:`ShapeCfg`."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    if sh.kind == "train":
        return {"batch": _batch_specs(cfg, sh.global_batch, sh.seq_len, True)}
    if sh.kind == "prefill":
        return {"batch": _batch_specs(cfg, sh.global_batch, sh.seq_len, False)}
    # decode: one new token + a full cache at context length
    cache = init_cache(cfg, sh.global_batch, sh.seq_len, window=sh.window, device=META)
    return {"batch": _batch_specs(cfg, sh.global_batch, 1, False), "cache": cache}
