"""Wrapper of the hand-written CUDA selective-scan kernels
(``csrc/selective_scan.cu``): the forward, the counterpart of the JAX
package's Pallas ``kernels/mamba_scan/kernel.py``, and the port's own
backward.

For CUDA tensors :func:`selective_scan` checks device, dtype, shape and
layout, allocates its outputs, launches on the current stream, raises if the
launch reports an error, and adds one to ``LAUNCHES["selective_scan"]``.
For CPU tensors it returns the plain version (``ref.py``); there is no
fallback from the card to the CPU.  Where autograd records (grad enabled and
an input requiring grad), the call goes through :class:`_ScanFn`, whose
forward also keeps the state entering each chunk of steps and whose
backward launches :func:`selective_scan_bwd` on the card
(``LAUNCHES["selective_scan_bwd"]``, two kernels a call) and runs the plain
backward on the CPU; the forward's outputs are the same either way.  Given
``meta`` tensors (the dry run's) the wrappers allocate what the kernels
would, launch nothing and report the call to ``kernels/meta.py``.  The
library is built at first use (``kernels/nvcc.py``); nothing is built or
loaded on import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import meta, nvcc
from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref, selective_scan_ref

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("mamba_scan", _HERE / "csrc" / "selective_scan.cu",
                          (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"selective_scan": 0, "selective_scan_bwd": 0}
MAX_STATE = 16  # the kernel keeps up to 16 states per channel in registers
BLOCK_CHANNELS = 128  # selective_scan.cu's kBwdCh: channels of one backward block
_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_LIB = {}  # the C entry points, resolved once, at the first launch


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    return nvcc.build(LIBRARIES, verbose)


def _entry(name):
    if name not in _LIB:
        lib = ctypes.CDLL(str(build()["selective_scan"]))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.selective_scan_fwd.argtypes = [p] * 8 + [ll] + [p] * 3 + [i] * 6 + [p]
        lib.selective_scan_bwd.argtypes = [p] * 8 + [ll] + [p] * 13 + [i] * 6 + [p]
        for fn in (lib.selective_scan_fwd, lib.selective_scan_bwd):
            fn.restype = ctypes.c_int
        _LIB.update(fwd=lib.selective_scan_fwd, bwd=lib.selective_scan_bwd)
    return _LIB[name]


def chunk_steps(dtype) -> int:
    """Steps of one chunk of the kernels (64 bytes of ``dtype``: 32 in bf16,
    16 in f32): the forward keeps the state entering each chunk."""
    return 64 // dtype.itemsize


def bwd_scratch(bsz: int, s: int, di: int, n: int):
    """Sizes in f32 elements of the backward kernel's two scratch buffers
    for (B, S, DI, N): ``part_bc``, the per-block partial sums of dB then dC
    (each (blocks, B, S, N), blocks = ceil(DI / BLOCK_CHANNELS)), and
    ``part_row``, the per-batch-row sums over time of d a (B, DI, N), dD
    (B, DI) and d dt_bias (B, DI)."""
    blocks = -(-di // BLOCK_CHANNELS)
    return 2 * blocks * bsz * s * n, bsz * di * n + 2 * bsz * di


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


def _check(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z) -> int:
    """Check the forward's arguments on either device (the kernel's
    contract, so the CPU path takes only what the kernel takes); returns
    z's row stride (0 in the base mode)."""
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
    return z_stride


def _fwd_kernel(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride, keep_states):
    """The forward kernel: ``(y, h_S, chunk states or None)``."""
    bsz, s, di = dt.shape
    n = a_log.shape[1]
    dev = dt.device
    fused = z is not None
    y = torch.empty_like(dt)
    chunks = -(-s // chunk_steps(dt.dtype))
    hs = (torch.empty((bsz, chunks, di, n), dtype=torch.float32, device=dev)
          if keep_states else None)
    if bsz * s * di == 0:
        return y, torch.zeros((bsz, di, n), dtype=torch.float32, device=dev), hs
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    if dt.is_meta:
        meta.note("selective_scan", 0, dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, y, h, hs)
        return y, h, hs
    err = _entry("fwd")(
        dt.data_ptr(), a_log.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(), x.data_ptr(),
        d_skip.data_ptr(), dt_bias.data_ptr() if fused else None,
        z.data_ptr() if fused else None, z_stride, y.data_ptr(), h.data_ptr(),
        hs.data_ptr() if keep_states else None, bsz, s, di, n, dt.dtype == _BF16,
        b_ssm.dtype == _BF16, nvcc.stream(dev),
    )
    if err:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA error {err}")
    LAUNCHES["selective_scan"] += 1
    return y, h, hs


def selective_scan_states(dt, a_log, b_ssm, c_ssm, x, d_skip, *, dt_bias=None, z=None):
    """The forward kernel keeping the state entering each chunk of
    :func:`chunk_steps` steps: ``(y, h_S, chunk_states (B, ceil(S / chunk),
    DI, N) f32)``, y and h_S the same bits as :func:`selective_scan`'s.  The
    backward kernel starts from those states.  On the card only."""
    z_stride = _check(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z)
    if not (dt.is_cuda or dt.is_meta):
        raise ValueError("the chunk states come from the kernel: CUDA tensors only")
    return _fwd_kernel(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride, True)


def selective_scan_bwd(dt, a_log, b_ssm, c_ssm, x, d_skip, dy, dh_last=None, *, dt_bias=None,
                       z=None, chunk_states=None):
    """The backward of :func:`selective_scan`: its inputs, ``dy`` (the
    output's gradient, (B, S, DI) in dt's dtype) and ``dh_last`` (h_S's,
    (B, DI, N) f32, or None for zero) -> the gradients of (dt, a_log, b_ssm,
    c_ssm, x, d_skip), and in the fused mode of (dt_bias, z) too, each in
    its input's dtype (dz contiguous).  CUDA tensors launch the kernels (the
    gradients with per-block partials of dB, dC, dA_log, dD and d dt_bias,
    then those summed in block order) from ``chunk_states``, the forward's
    (:func:`selective_scan_states`); CPU tensors run
    :func:`ref.selective_scan_bwd_ref`."""
    z_stride = _check(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z)
    bsz, s, di = dt.shape
    n = a_log.shape[1]
    dev = dt.device
    nvcc.check_tensor("dy", dy, (dt.dtype,), (bsz, s, di), dev)
    if dh_last is not None:
        nvcc.check_tensor("dh_last", dh_last, (torch.float32,), (bsz, di, n), dev)
    if chunk_states is not None:
        nvcc.check_tensor("chunk_states", chunk_states, (torch.float32,),
                          (bsz, -(-s // chunk_steps(dt.dtype)), di, n), dev)
    if not (dt.is_cuda or dt.is_meta):
        return selective_scan_bwd_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, dy, dh_last,
                                      dt_bias=dt_bias, z=z)
    fused = z is not None
    if chunk_states is None:
        raise ValueError("the backward kernel starts from the forward's chunk states "
                         "(selective_scan_states)")
    grads = [torch.empty_like(dt), torch.empty_like(a_log), torch.empty_like(b_ssm),
             torch.empty_like(c_ssm), torch.empty_like(x), torch.empty_like(d_skip)]
    if fused:
        grads += [torch.empty_like(dt_bias), torch.empty((bsz, s, di), dtype=z.dtype,
                                                         device=dev)]
    if bsz * s * di == 0:
        return tuple(g.zero_() for g in grads)
    n_bc, n_row = bwd_scratch(bsz, s, di, n)
    part_bc = torch.empty(n_bc, dtype=torch.float32, device=dev)
    part_row = torch.empty(n_row, dtype=torch.float32, device=dev)
    if dt.is_meta:
        meta.note("selective_scan_bwd", 0, dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, dy,
                  dh_last, chunk_states, *grads)
        return tuple(grads)
    err = _entry("bwd")(
        dt.data_ptr(), a_log.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(), x.data_ptr(),
        d_skip.data_ptr(), dt_bias.data_ptr() if fused else None,
        z.data_ptr() if fused else None, z_stride, dy.data_ptr(),
        dh_last.data_ptr() if dh_last is not None else None, chunk_states.data_ptr(),
        *(g.data_ptr() for g in grads[:6]), grads[6].data_ptr() if fused else None,
        grads[7].data_ptr() if fused else None, part_bc.data_ptr(), part_row.data_ptr(),
        bsz, s, di, n, dt.dtype == _BF16, b_ssm.dtype == _BF16, nvcc.stream(dev),
    )
    if err:
        raise RuntimeError(f"selective scan backward kernel launch failed: CUDA error {err}")
    LAUNCHES["selective_scan_bwd"] += 1
    return tuple(grads)


class _ScanFn(torch.autograd.Function):
    """The selective scan under autograd: the forward (on the card keeping
    its chunk states), the backward :func:`selective_scan_bwd` seeded by
    h_S's gradient where autograd gives one."""

    @staticmethod
    def forward(ctx, dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride):
        if dt.is_cuda or dt.is_meta:
            y, h, hs = _fwd_kernel(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride,
                                   True)
        else:
            (y, h), hs = selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip,
                                            dt_bias=dt_bias, z=z), None
        ctx.save_for_backward(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, hs)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh):
        dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, hs = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        grads = selective_scan_bwd(dt, a_log, b_ssm, c_ssm, x, d_skip, dy,
                                   None if dh is None else dh.contiguous(), dt_bias=dt_bias,
                                   z=z, chunk_states=hs)
        return (*grads, *(None,) * (9 - len(grads)))


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
    z_stride = _check(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z)):
        return _ScanFn.apply(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride)
    if not (dt.is_cuda or dt.is_meta):
        return selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias=dt_bias, z=z)
    return _fwd_kernel(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias, z, z_stride, False)[:2]
