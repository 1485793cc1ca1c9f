"""Sharding rules: parameter, optimizer, batch and cache partition specs
per arch (counterpart of the JAX package's ``launch/sharding.py``).

The reference's scheme (megatron-style TP on the ``model`` axis + ZeRO/FSDP
on the data axes):

  embed (V, D)                     -> (model, data)
  lm_head (D, V)                   -> (data, model)
  attn wq/wk/wv (..., D, H*hd)     -> (..., data, model)     head-sharded TP
  attn wo (..., H*hd, D)           -> (..., model, data)
  mlp w1/w3 (..., D, F)            -> (..., data, model)
  mlp w2 (..., F, D)               -> (..., model, data)
  moe router (..., D, E)           -> (..., data, None)
  moe w1/w3 (..., E, D, F)         -> (..., model, data, None)   expert parallel
  moe w2 (..., E, F, D)            -> (..., model, None, data)
  mamba in/out projections         -> like mlp (d_inner on model)
  norms / biases / gates / scalars -> model on the channel dim where it is
                                      d_inner-sized, else replicated

``...`` are the leading layer-stack axes (never sharded).  On the multi-pod
mesh the data axes are ('pod', 'data').  Batch: (B, ...) over the data
axes.  Decode caches: batch over data (when divisible), the context over
model.

A spec is a tuple with the entries of the reference's ``PartitionSpec``
(an axis name, a tuple of axis names, or None); ``()`` is replicated.  The
functions return trees of specs shaped as the trees they are given.  The
port runs on one card and shards nothing: the specs say how the
reference's mesh would split each leaf, and :func:`local_shape` /
:func:`sharded_bytes` what one device of that mesh would hold (in place of
the reference's ``to_named``).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig

Spec = Tuple[Any, ...]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``path``
    the keys down to the leaf (dict keys, list positions as strings)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _data(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _param_rule(path: Tuple[str, ...], ndim: int, cfg: ModelConfig, d) -> Spec:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    in_moe = "moe" in path

    def lead(k):
        return (None,) * (ndim - k)

    if name == "embed":
        return ("model", d)
    if name == "lm_head":
        return (d, "model")
    if name in ("wq", "wk", "wv"):
        return (*lead(2), d, "model")
    if name == "wo":
        return (*lead(2), "model", d)
    if name in ("w1", "w3"):
        if in_moe and parent == "moe":  # (..., E, D, F)
            return (*lead(3), "model", d, None)
        return (*lead(2), d, "model")
    if name == "w2":
        if in_moe and parent == "moe":  # (..., E, F, D)
            return (*lead(3), "model", None, d)
        return (*lead(2), "model", d)
    if name == "router":
        return (*lead(2), d, None)
    if name == "in_proj":
        return (*lead(2), d, "model")
    if name == "out_proj":
        return (*lead(2), "model", d)
    if name in ("conv_w", "x_proj"):
        return (*lead(2), "model", None)
    if name == "dt_proj":
        return (*lead(2), None, "model")
    if name == "A_log" and cfg.ssm_version == 1:
        return (*lead(2), "model", None)
    if name in ("conv_b", "dt_bias", "D_skip", "norm_scale", "A_log", "bq", "bk", "bv"):
        return (*lead(1), "model")
    return ()  # norms, gates, counters: replicated


def param_pspecs(abstract_params, cfg: ModelConfig, mesh: Mesh):
    d = _data(mesh)
    return _map_with_path(lambda path, leaf: _param_rule(path, leaf.dim(), cfg, d),
                          abstract_params)


def opt_pspecs(abstract_opt, param_specs):
    return {"m": param_specs, "v": param_specs, "count": ()}


def batch_pspecs(batch_specs, mesh: Mesh, *, shard_batch: bool = True):
    d = _data(mesh)

    def rule(path, leaf):
        if not shard_batch or leaf.shape[0] == 1:
            return ()
        return (d, *([None] * (leaf.dim() - 1)))

    return _map_with_path(rule, batch_specs)


def cache_pspecs(cache_specs, cfg: ModelConfig, mesh: Mesh, batch_size: int):
    """Decode caches: batch over data (when divisible), context over model."""
    d = _data(mesh)
    n_data = mesh.shape["data"] * mesh.shape.get("pod", 1)
    bspec = d if batch_size % n_data == 0 and batch_size > 1 else None

    def rule(path, leaf):
        name = path[-1]
        if name == "len":
            return ()
        nd = leaf.dim()
        if name in ("k", "v", "attn_k", "attn_v", "img_k", "img_v"):
            # (L..., B, W, kv, hd): batch over data, context over model
            return (*([None] * (nd - 4)), bspec, "model", None, None)
        if name in ("ssm", "tail_ssm"):
            # (L..., B, H|DI, P?, N): batch over data, channel/head over model
            if cfg.ssm_version == 2:
                return (*([None] * (nd - 4)), bspec, "model", None, None)
            return (*([None] * (nd - 3)), bspec, "model", None)
        if name in ("conv", "tail_conv"):
            # (L..., B, K-1, C): channel over model
            return (*([None] * (nd - 3)), bspec, None, "model")
        return ()

    return _map_with_path(rule, cache_specs)


def local_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` split by ``spec`` over
    ``mesh``: each dimension divided (rounded up) by the sizes of the axes
    its entry names."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(-(-n // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


def sharded_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device of ``mesh`` holds of the tensors of ``tree`` under
    ``specs`` (a tree of the same shape); non-tensor leaves hold none."""
    total = 0

    def add(path, leaf):
        nonlocal total
        if hasattr(leaf, "element_size"):
            spec = _leaf_at(specs, path)
            total += math.prod(local_shape(leaf.shape, spec, mesh)) * leaf.element_size()
        return leaf

    _map_with_path(add, tree)
    return total


def _leaf_at(tree, path):
    for key in path:
        tree = tree[key] if isinstance(tree, dict) else tree[int(key)]
    return tree
