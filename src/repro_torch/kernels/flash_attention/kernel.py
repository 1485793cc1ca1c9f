"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``): the forward, the counterpart of the JAX
package's Pallas ``kernels/flash_attention/kernel.py``, and the port's own
backward.

For CUDA tensors :func:`flash_attention` checks device, dtype, shape and
contiguity, allocates its output, launches on the current stream, raises if
the launch reports an error, and adds one to ``LAUNCHES["flash_attention"]``.
For CPU tensors it returns the plain version (``ref.py``); there is no
fallback from the card to the CPU.  Where autograd records (grad enabled and
q, k or v requiring grad), the call goes through :class:`_FlashFn`: its
forward also has the kernel write the rows' log-sum-exp, and its backward
launches ``flash_attention_bwd`` (``LAUNCHES["flash_attention_bwd"]``, one a
call: three kernels on wgmma and TMA in bf16, two scalar ones in f32); on
the CPU it runs the plain forward, row log-sum-exp and backward formula.
Every head dim from 1 to 128 runs (:func:`kernel_head_dim`): one without
its own instance is zero-padded on the head axis to the next instantiated
width, the kernels get the true ``scale = 1/sqrt(hd)``, and the outputs
are sliced back.  Given ``meta`` tensors (the dry run's) the wrappers
allocate what the kernels would, launch nothing and report the call to
``kernels/meta.py``.  The library is built at first use
(``kernels/nvcc.py``); nothing is built or loaded on import.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import meta, nvcc
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

_HERE = Path(__file__).resolve().parent
LIBRARIES = (nvcc.Library("flash_attention", _HERE / "csrc" / "flash_attention.cu",
                          (nvcc.MODEL_COMMON,)),)
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
HEAD_DIMS = (16, 32, 64, 112, 128)  # the head widths the kernel is instantiated for
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
        lib = ctypes.CDLL(str(build()["flash_attention"]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 7 + [f, i, p]
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 7 + [f, i, p]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd):
            fn.restype = ctypes.c_int
        _LIB.update(flash_attention_fwd=lib.flash_attention_fwd,
                    flash_attention_bwd=lib.flash_attention_bwd)
    return _LIB[name]


def _check(q, k, v):
    """(B, S, T, Hq, Hkv, hd), after raising on what the kernels do not take."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    nvcc.check_tensors(q.device, ("q", q, _DTYPES, (b, s, hq, hd)),
                       ("k", k, (q.dtype,), (b, t, hkv, hd)),
                       ("v", v, (q.dtype,), (b, t, hkv, hd)))
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    kernel_head_dim(hd)
    return b, s, t, hq, hkv, hd


def kernel_head_dim(hd: int) -> int:
    """The width head dim ``hd`` runs at on the card: its own instance, else
    the smallest instantiated width above it, the head axis zero-padded
    (zero columns change neither the scores nor the output's kept columns).
    Raises outside 1..128, on either device."""
    if hd >= 1:
        for width in HEAD_DIMS:
            if hd <= width:
                return width
    raise ValueError(f"head dim {hd} not in 1..{HEAD_DIMS[-1]}")


def _padded(width, *xs):
    """``xs`` zero-padded on the last axis to ``width`` (new, aligned
    storage), or as given where they are that wide already."""
    return tuple(x if x.shape[-1] == width
                 else torch.nn.functional.pad(x, (0, width - x.shape[-1])) for x in xs)


def _cut(hd, *xs):
    """``xs`` cut back to their first ``hd`` columns (contiguous copies)."""
    return tuple(x if x.shape[-1] == hd else x[..., :hd].contiguous() for x in xs)


def _forward(q, k, v, causal, with_lse):
    """The forward on checked inputs: ``(out, lse)``, the rows' log-sum-exp
    (B, Hq, S) f32 where ``with_lse`` (else None: the kernel is given a null
    pointer).  CPU tensors run the plain versions."""
    if not (q.is_cuda or q.is_meta):
        out = attention_ref(q, k, v, causal=causal)
        if not with_lse:
            return out, None
        return out.contiguous(), attention_lse_ref(q, k, causal=causal)
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * s * hq == 0:
        return torch.empty_like(q), lse
    if t == 0:
        raise ValueError("attention over an empty key sequence")
    if q.is_meta:  # the function's products, at the true head dim
        out = torch.empty_like(q)
        meta.note("flash_attention", 4 * b * hq * hd * meta.attention_pairs(s, t, causal),
                  q, k, v, out, lse)
        return out, lse
    width = kernel_head_dim(hd)
    q, k, v = _padded(width, q, k, v)
    bf16 = q.dtype == _BF16
    if bf16:  # the tensor-core kernel copies 16-byte rows: align an offset view
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    err = _entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, t, hq, hkv, width, causal,
        1.0 / math.sqrt(hd), bf16, nvcc.stream(q.get_device()))
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return _cut(hd, out)[0], lse


def bwd_scratch_shape(b, hq, s, dtype):
    """The f32 scratch of one backward call: in bf16 the row LSE times
    log2 e and D = rowsum(dO o), (B, Hq, 2, S rounded up to 128); in f32 D
    alone, (B, Hq, S)."""
    if dtype == _BF16:
        return (b, hq, 2, -(-s // 128) * 128)
    return (b, hq, s)


def flash_attention_lse(q, k, v, *, causal: bool = True):
    """``(out, lse)``: the forward and the rows' log-sum-exp of the scaled
    scores, (B, Hq, S) f32, from one kernel launch (the plain versions for
    CPU tensors)."""
    _check(q, k, v)
    return _forward(q, k, v, causal, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The backward from the forward's ``o`` and ``lse`` and the output's
    gradient ``do`` (shaped and typed as q) -> ``(dq, dk, dv)``.  CUDA
    tensors launch the kernels (bf16: a preprocess writing rowsum(do o)
    and the scaled LSE into a scratch buffer, then dq and dk/dv on wgmma;
    f32: dq, which writes rowsum(do o), then dk/dv on scalar FMAs), CPU
    tensors run :func:`ref.attention_bwd_ref`."""
    b, s, t, hq, hkv, hd = _check(q, k, v)
    nvcc.check_tensors(q.device, ("o", o, (q.dtype,), q.shape), ("do", do, (q.dtype,), q.shape),
                       ("lse", lse, (torch.float32,), (b, hq, s)))
    if not (q.is_cuda or q.is_meta):
        return attention_bwd_ref(q, k, v, o, lse, do, causal)
    if b * s * hq == 0 or t == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    scratch = torch.empty(bwd_scratch_shape(b, hq, s, q.dtype), dtype=torch.float32,
                          device=q.device)
    if q.is_meta:  # 7 products a pair: S and dO V^T in both kernels, dQ, dK, dV
        # (dQ's second bf16 half of dS, a rounding correction, not counted)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        meta.note("flash_attention_bwd", 14 * b * hq * hd * meta.attention_pairs(s, t, causal),
                  q, k, v, o, lse, do, dq, dk, dv)
        return dq, dk, dv
    width = kernel_head_dim(hd)
    q, k, v, o, do = _padded(width, q, k, v, o, do)
    if q.dtype == _BF16:  # TMA and 16-byte rows want aligned bases: align offset views
        q, k, v, o, do = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, s, t, hq, hkv,
        width, causal, 1.0 / math.sqrt(hd), q.dtype == _BF16, nvcc.stream(q.get_device()))
    if err:
        raise RuntimeError(f"flash attention backward launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return _cut(hd, dq, dk, dv)


class _FlashFn(torch.autograd.Function):
    """Flash attention under autograd: the forward with the rows'
    log-sum-exp, the backward :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, Hq, hd); k/v: (B, T, Hkv, hd), all f32 or all bf16, Hq a
    multiple of Hkv (query head h reads kv head h // (Hq/Hkv)), hd from 1
    to 128 (``kernel_head_dim``) -> (B, S, Hq, hd) in q's dtype.  Any S: a
    ragged last query tile is masked, never dropped.  The arguments are checked on either device, so the CPU
    path takes only what the kernel takes.  bf16 runs on the tensor cores,
    f32 on the scalar kernel."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]
