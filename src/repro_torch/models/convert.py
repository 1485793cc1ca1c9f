"""Carry parameters between the JAX package and the port.

The two packages draw different random numbers from the same seed, so a
test that holds one against the other makes the parameters once, with the
JAX package's ``init_params``, and hands them across as numpy arrays
(``jax.device_get``).  :func:`params_from_numpy` checks that tree against
the port's :func:`~repro_torch.models.model.param_spec` (names, shapes and
dtypes) and moves it onto the device; :func:`params_to_numpy` is its
inverse.  bf16 leaves (numpy's ``bfloat16`` extension dtype, as JAX hands
them out) cross bit for bit; :func:`params_to_numpy` returns them widened
to float32, which is exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import param_spec
from repro_torch.runtime.dfc_shard import resolve_device

_NP_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16}


def _leaf_from_numpy(path: str, arr, leaf, device) -> torch.Tensor:
    shape, dtype, _ = leaf
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # 2-byte extension dtype: move the bits
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    elif arr.dtype in _NP_DTYPES:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    else:
        raise TypeError(f"{path}: unsupported dtype {arr.dtype}")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, expected {shape} {dtype}")
    return t.to(resolve_device(device)).contiguous()


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device``.  Raises on a missing or extra name, or a leaf whose shape
    or dtype differs from the port's spec for ``cfg``."""
    def walk(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: names {got} != {sorted(spec)}")
            return {k: walk(node[k], spec[k], f"{path}/{k}") for k in spec}
        return _leaf_from_numpy(path, node, spec, device)

    return walk(tree, param_spec(cfg), "")


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters as numpy arrays (bf16 widened to float32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
