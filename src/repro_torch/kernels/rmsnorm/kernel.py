"""Wrapper of the hand-written CUDA RMSNorm kernels (``csrc/rmsnorm.cu``):
the forward, the counterpart of the JAX package's Pallas
``kernels/rmsnorm/kernel.py``, and the port's own backward.

For a CUDA tensor :func:`rmsnorm` checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises if
the launch reports an error, and adds one to ``LAUNCHES["rmsnorm"]``.  For a
CPU tensor it returns the plain version (``ref.py``); there is no fallback
from the card to the CPU.  Where autograd records (grad enabled and ``x`` or
``w`` requiring grad), the call goes through :class:`_RMSNormFn`, whose
backward launches ``rmsnorm_bwd`` on the card (``LAUNCHES["rmsnorm_bwd"]``,
two kernels a call) and runs the plain backward formula on the CPU; the
forward is the same either way.  Given ``meta`` tensors (the dry run's)
the wrappers allocate what the kernels would, launch nothing and report the
call to ``kernels/meta.py``.  The library is built at first use
(``kernels/nvcc.py``); nothing is built or loaded on import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import meta, nvcc
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("rmsnorm", _HERE / "csrc" / "rmsnorm.cu", (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "rmsnorm_bwd": 0}
_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
BWD_BLOCKS = 512  # rmsnorm.cu's kBwdBlocks: most rows of the dw partials
BWD_MAX_D = 8192  # rmsnorm.cu's kThreads x kBwdMaxCols (and 1024 vectors of bf16)
_LIB = {}  # the C entry points, resolved once, at the first launch


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _entry(name):
    if name not in _LIB:
        lib = ctypes.CDLL(str(build()["rmsnorm"]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rmsnorm_fwd.argtypes = [p, p, p, i, i, i, i, f, p]
        lib.rmsnorm_bwd.argtypes = [p] * 6 + [i] * 4 + [f, p]
        for fn in (lib.rmsnorm_fwd, lib.rmsnorm_bwd):
            fn.restype = ctypes.c_int
        _LIB.update(rmsnorm_fwd=lib.rmsnorm_fwd, rmsnorm_bwd=lib.rmsnorm_bwd)
    return _LIB[name]


def _fwd_kernel(x, w, eps):
    r, d = x.shape
    out = torch.empty_like(x)
    if r == 0 or d == 0:
        return out
    if x.is_meta:
        meta.note("rmsnorm", 0, x, w, out)
        return out
    if x.data_ptr() % 16:  # the kernels read 16-byte vectors: align an offset view
        x = x.clone()
    err = _entry("rmsnorm_fwd")(x.data_ptr(), w.data_ptr(), out.data_ptr(), r, d,
                                x.dtype == _BF16, w.dtype == _BF16, eps,
                                nvcc.stream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-6):
    """The backward: x, dy (R, D) in one dtype; w (D,) -> ``(dx, dw)`` in
    x's and w's dtypes.  CUDA tensors launch the kernels (dx and the dw
    partials, then dw summed in block order; an input whose storage is off
    the 16-byte vector is copied to aligned storage first), CPU tensors run
    :func:`ref.rmsnorm_bwd_ref`."""
    r, d = x.shape
    nvcc.check_tensors(x.device, ("x", x, _DTYPES, (r, d)), ("w", w, _DTYPES, (d,)),
                       ("dy", dy, (x.dtype,), (r, d)))
    if not (x.is_cuda or x.is_meta):
        return rmsnorm_bwd_ref(x, w, dy, eps)
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm backward takes D <= {BWD_MAX_D}, got {d}")
    dx = torch.empty_like(x)
    if r == 0 or d == 0:
        return dx, torch.zeros_like(w)
    # the row kernel reads 16-byte vectors: align an offset view
    x, dy = (t.clone() if t.data_ptr() % 16 else t for t in (x, dy))
    dw = torch.empty_like(w)
    partial = torch.empty((min(r, BWD_BLOCKS), d), dtype=torch.float32, device=x.device)
    if x.is_meta:
        meta.note("rmsnorm_bwd", 0, x, w, dy, dx, dw)
        return dx, dw
    err = _entry("rmsnorm_bwd")(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                dw.data_ptr(), partial.data_ptr(), r, d, x.dtype == _BF16,
                                w.dtype == _BF16, eps, nvcc.stream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA error {err}")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw


class _RMSNormFn(torch.autograd.Function):
    """RMSNorm under autograd: the forward kernel (or plain version), the
    backward :func:`rmsnorm_bwd`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _fwd_kernel(x, w, eps) if x.is_cuda or x.is_meta else rmsnorm_ref(x, w, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x, w, *, eps: float = 1e-6):
    """x: (R, D) f32 or bf16; w: (D,) f32 or bf16 -> (R, D) in x's dtype.
    The arguments are checked on either device, so the CPU path takes only
    what the kernel takes."""
    r, d = x.shape
    nvcc.check_tensors(x.device, ("x", x, _DTYPES, (r, d)), ("w", w, _DTYPES, (d,)))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNormFn.apply(x, w, eps)
    if not (x.is_cuda or x.is_meta):
        return rmsnorm_ref(x, w, eps)
    return _fwd_kernel(x, w, eps)
