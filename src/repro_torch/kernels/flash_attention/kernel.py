"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the counterpart of the JAX package's Pallas
``kernels/flash_attention/kernel.py``.

For CUDA tensors :func:`flash_attention` checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises if
the launch reports an error, and adds one to ``LAUNCHES["flash_attention"]``.
For CPU tensors it returns the plain version (``ref.py``); there is no
fallback from the card to the CPU.  The library is built at first use
(``kernels/nvcc.py``); nothing is built or loaded on import.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention.ref import attention_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("flash_attention", _HERE / "csrc" / "flash_attention.cu",
                          (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (16, 32, 64, 112, 128)  # the head widths the kernel is instantiated for
_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_FWD = None  # the C entry point, resolved once, at the first launch


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _fwd():
    global _FWD
    if _FWD is None:
        fn = ctypes.CDLL(str(build()["flash_attention"])).flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FWD = fn
    return _FWD


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, Hq, hd); k/v: (B, T, Hkv, hd), all f32 or all bf16, Hq a
    multiple of Hkv (query head h reads kv head h // (Hq/Hkv)) ->
    (B, S, Hq, hd) in q's dtype.  Any S: a ragged last query tile is masked,
    never dropped.  The arguments are checked on either device, so the CPU
    path takes only what the kernel takes.  bf16 runs on the tensor cores,
    f32 on the scalar kernel."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dev = q.device
    nvcc.check_tensors(dev, ("q", q, _DTYPES, (b, s, hq, hd)),
                       ("k", k, (q.dtype,), (b, t, hkv, hd)),
                       ("v", v, (q.dtype,), (b, t, hkv, hd)))
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal)
    out = torch.empty_like(q)
    if b * s * hq == 0:
        return out
    if t == 0:
        raise ValueError("attention over an empty key sequence")
    bf16 = q.dtype == _BF16
    if bf16:  # the tensor-core kernel copies 16-byte rows: align an offset view
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, hq,
                 hkv, hd, causal, 1.0 / math.sqrt(hd), bf16, nvcc.stream(q.get_device()))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
