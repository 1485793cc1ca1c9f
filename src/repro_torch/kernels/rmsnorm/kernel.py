"""Wrapper of the hand-written CUDA RMSNorm kernel (``csrc/rmsnorm.cu``),
the counterpart of the JAX package's Pallas ``kernels/rmsnorm/kernel.py``.

For a CUDA tensor :func:`rmsnorm` checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises if
the launch reports an error, and adds one to ``LAUNCHES["rmsnorm"]``.  For a
CPU tensor it returns the plain version (``ref.py``); there is no fallback
from the card to the CPU.  The library is built at first use
(``kernels/nvcc.py``); nothing is built or loaded on import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("rmsnorm", _HERE / "csrc" / "rmsnorm.cu", (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"rmsnorm": 0}
_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_FWD = None  # the C entry point, resolved once, at the first launch


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _fwd():
    global _FWD
    if _FWD is None:
        fn = ctypes.CDLL(str(build()["rmsnorm"])).rmsnorm_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FWD = fn
    return _FWD


def rmsnorm(x, w, *, eps: float = 1e-6):
    """x: (R, D) f32 or bf16; w: (D,) f32 or bf16 -> (R, D) in x's dtype.
    The arguments are checked on either device, so the CPU path takes only
    what the kernel takes."""
    r, d = x.shape
    nvcc.check_tensors(x.device, ("x", x, _DTYPES, (r, d)), ("w", w, _DTYPES, (d,)))
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    out = torch.empty_like(x)
    if r == 0 or d == 0:
        return out
    if x.data_ptr() % 16:  # the kernels read 16-byte vectors: align an offset view
        x = x.clone()
    err = _fwd()(x.data_ptr(), w.data_ptr(), out.data_ptr(), r, d, x.dtype == _BF16,
                 w.dtype == _BF16, eps, nvcc.stream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out
