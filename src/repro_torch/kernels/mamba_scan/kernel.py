"""Wrapper of the hand-written CUDA selective-scan kernel
(``csrc/selective_scan.cu``), the counterpart of the JAX package's Pallas
``kernels/mamba_scan/kernel.py``.

For CUDA tensors :func:`selective_scan` checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch reports an error, and adds one to
``LAUNCHES["selective_scan"]``.  For CPU tensors it returns the plain
version (``ref.py``); there is no fallback from the card to the CPU.  The
library is built at first use (``kernels/nvcc.py``); nothing is built or
loaded on import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("mamba_scan", _HERE / "csrc" / "selective_scan.cu",
                          (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"selective_scan": 0}
MAX_STATE = 16  # the kernel keeps up to 16 states per channel in registers
_DTYPES = (torch.float32, torch.bfloat16)
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    LAUNCHES["selective_scan"] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()["selective_scan"]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.selective_scan_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def selective_scan(dt, a_log, b_ssm, c_ssm, x, d_skip):
    """dt/x: (B, S, DI) f32 or bf16 (one dtype); a_log: (DI, N) f32;
    b_ssm/c_ssm: (B, S, N) f32 or bf16 (one dtype); d_skip: (DI,) f32, N <=
    16 -> ``(y (B, S, DI) in dt's dtype, h_S (B, DI, N) f32)``: the output
    and the state after the last step.  The arguments are checked on either
    device, so the CPU path takes only what the kernel takes."""
    bsz, s, di = dt.shape
    n = a_log.shape[1]
    dev = dt.device
    nvcc.check_tensor("dt", dt, _DTYPES, (bsz, s, di), dev)
    nvcc.check_tensor("x", x, (dt.dtype,), (bsz, s, di), dev)
    nvcc.check_tensor("a_log", a_log, (torch.float32,), (di, n), dev)
    nvcc.check_tensor("b_ssm", b_ssm, _DTYPES, (bsz, s, n), dev)
    nvcc.check_tensor("c_ssm", c_ssm, (b_ssm.dtype,), (bsz, s, n), dev)
    nvcc.check_tensor("d_skip", d_skip, (torch.float32,), (di,), dev)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} outside [1, {MAX_STATE}]")
    if not dt.is_cuda:
        return selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip)
    y = torch.empty_like(dt)
    if bsz * s * di == 0:
        return y, torch.zeros((bsz, di, n), dtype=torch.float32, device=dev)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    err = _lib().selective_scan_fwd(
        dt.data_ptr(), a_log.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        x.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h.data_ptr(),
        bsz, s, di, n, int(dt.dtype == torch.bfloat16),
        int(b_ssm.dtype == torch.bfloat16), nvcc.stream(dev),
    )
    if err:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA error {err}")
    LAUNCHES["selective_scan"] += 1
    return y, h
