"""Wrapper of the hand-written CUDA selective-scan kernel
(``csrc/selective_scan.cu``), the counterpart of the JAX package's Pallas
``kernels/mamba_scan/kernel.py``.

For CUDA tensors :func:`selective_scan` checks device, dtype, shape and
layout, allocates its outputs, launches on the current stream, raises if the
launch reports an error, and adds one to ``LAUNCHES["selective_scan"]``.
For CPU tensors it returns the plain version (``ref.py``); there is no
fallback from the card to the CPU.  The kernel has no backward yet
(ROADMAP A7): a CUDA call that autograd would record raises
``NotImplementedError`` rather than return an output that silently cuts the
gradient; the CPU's plain version stays differentiable.  The library is
built at first use (``kernels/nvcc.py``); nothing is built or loaded on
import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("mamba_scan", _HERE / "csrc" / "selective_scan.cu",
                          (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"selective_scan": 0}
MAX_STATE = 16  # the kernel keeps up to 16 states per channel in registers
_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_FWD = None  # the C entry point, resolved once, at the first launch
SCAN_NO_BACKWARD = ("the selective scan kernel has no backward yet (ROADMAP A7): "
                    "training an ssm model on the card waits for it")


def reset_launches() -> None:
    LAUNCHES["selective_scan"] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _fwd():
    global _FWD
    if _FWD is None:
        fn = ctypes.CDLL(str(build()["selective_scan"])).selective_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [ctypes.c_longlong] + [p] * 2 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
        _FWD = fn
    return _FWD


def _check_z(z, shape, dtype, device) -> int:
    """The row stride of ``z``: (B, S, DI) in ``dtype`` on ``device`` whose
    rows (b, s) lie one stride apart with their DI elements contiguous, as
    the second half of an in_proj output ``xz`` (stride 2 DI) or a
    contiguous tensor (stride DI)."""
    if z.device != device:
        raise ValueError(f"z is on {z.device}, expected {device}")
    if z.dtype != dtype:
        raise TypeError(f"z has dtype {z.dtype}, expected {dtype}")
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {tuple(shape)}")
    bsz, s, di = shape
    zs = z.stride(1) if s > 1 else (z.stride(0) if bsz > 1 else di)
    if ((di > 1 and z.stride(2) != 1) or zs < di
            or (s > 1 and bsz > 1 and z.stride(0) != s * zs)):
        raise ValueError(f"z has strides {z.stride()}: its rows must be contiguous and "
                         "one row stride apart")
    return zs


def selective_scan(dt, a_log, b_ssm, c_ssm, x, d_skip, *, dt_bias=None, z=None):
    """Base mode (no ``dt_bias``, no ``z``): dt/x (B, S, DI) f32 or bf16 (one
    dtype); a_log (DI, N) f32; b_ssm/c_ssm (B, S, N) f32 or bf16 (one
    dtype); d_skip (DI,) f32; N <= 16 -> ``(y (B, S, DI) in dt's dtype,
    h_S (B, DI, N) f32)``: the output and the state after the last step.

    Fused mode (both ``dt_bias`` and ``z``), the mamba1 block's prefill:
    ``dt`` is dt_pre (``dt_raw @ dt_proj``), ``dt_bias`` (DI,) and ``x``,
    ``b_ssm``, ``c_ssm`` in dt's dtype, ``z`` (B, S, DI) in dt's dtype with
    contiguous rows at any row stride (the strided half of ``xz``) ->
    ``(T((scan y) * silu(z)), h_S)`` with ``dt = T(softplus(T(dt_pre +
    dt_bias)))``, T being dt's dtype.

    The arguments are checked on either device, so the CPU path takes only
    what the kernel takes."""
    bsz, s, di = dt.shape
    n = a_log.shape[1]
    dev = dt.device
    fused = z is not None
    if fused != (dt_bias is not None):
        raise ValueError("mode mismatch: the fused mode takes both dt_bias and z, the base "
                         "mode neither")
    bc_dtypes = (dt.dtype,) if fused else _DTYPES
    nvcc.check_tensors(dev, ("dt", dt, _DTYPES, (bsz, s, di)),
                       ("x", x, (dt.dtype,), (bsz, s, di)),
                       ("a_log", a_log, (torch.float32,), (di, n)),
                       ("b_ssm", b_ssm, bc_dtypes, (bsz, s, n)),
                       ("c_ssm", c_ssm, (b_ssm.dtype,), (bsz, s, n)),
                       ("d_skip", d_skip, (torch.float32,), (di,)))
    z_stride = 0
    if fused:
        nvcc.check_tensor("dt_bias", dt_bias, (dt.dtype,), (di,), dev)
        z_stride = _check_z(z, (bsz, s, di), dt.dtype, dev)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} outside [1, {MAX_STATE}]")
    if not dt.is_cuda:
        return selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias=dt_bias, z=z)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z)):
        raise NotImplementedError(SCAN_NO_BACKWARD)
    y = torch.empty_like(dt)
    if bsz * s * di == 0:
        return y, torch.zeros((bsz, di, n), dtype=torch.float32, device=dev)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    err = _fwd()(
        dt.data_ptr(), a_log.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(), x.data_ptr(),
        d_skip.data_ptr(), dt_bias.data_ptr() if fused else None,
        z.data_ptr() if fused else None, z_stride, y.data_ptr(), h.data_ptr(),
        bsz, s, di, n, dt.dtype == _BF16, b_ssm.dtype == _BF16, nvcc.stream(dev),
    )
    if err:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA error {err}")
    LAUNCHES["selective_scan"] += 1
    return y, h
