"""Wrappers of the hand-written CUDA combine kernels (``csrc/dfc_reduce.cu``).

One wrapper per kernel, each the counterpart of a ``dfc_*_reduce_grid_call``
of the JAX package (one program instance -- here one thread block -- per
shard).  For a CUDA tensor a wrapper checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to
``LAUNCHES[kind]``.  For a CPU tensor it returns the plain PyTorch version
from ``ref.py``; there is no fallback from the card to the CPU.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``build/dfc_reduce/<source hash>/`` under the repository root and loaded
with ``ctypes``.  Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.core.torch_dfc import map_geometry
from repro_torch.kernels.dfc_reduce import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "dfc_reduce.cu"
BUILD_ROOT = Path(__file__).resolve().parents[4] / "build" / "dfc_reduce"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# launches per kernel since the last reset (only real CUDA launches count)
LAUNCHES: Dict[str, int] = {"stack": 0, "queue": 0, "deque": 0, "map": 0}
# shared memory a block may use on Hopper, minus the static rank scratch
_MAX_ELIM_BYTES = 232448 - 1024

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA combine kernels cannot be built")


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libdfc_reduce.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (cached by a hash of source and flags); returns
    the shared library's path.  ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report of registers and shared memory."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dfc_stack_reduce.argtypes = [p] * 8 + [i, i, p]
        lib.dfc_queue_reduce.argtypes = [p] * 8 + [i, i, p]
        lib.dfc_deque_reduce.argtypes = [p] * 10 + [i, i, p]
        lib.dfc_map_reduce.argtypes = [p] * 13 + [i] * 5 + [p]
        for fn in ("dfc_stack_reduce", "dfc_queue_reduce", "dfc_deque_reduce",
                   "dfc_map_reduce"):
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lanes(n: int) -> None:
    if (n + 1) // 2 * 4 > _MAX_ELIM_BYTES:
        raise ValueError(f"{n} lanes exceed the kernel's shared-memory budget")


def _raise_on(err: int, kind: str) -> None:
    if err != 0:
        raise RuntimeError(f"dfc {kind} kernel launch failed: CUDA error {err}")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ring_call(kind, fn_name, ops, params, windows, sizes, n_seg):
    s, n = ops.shape
    dev = ops.device
    for name, t, dt in (("ops", ops, torch.int32), ("params", params, torch.float32)):
        _check(name, t, dt, (s, n), dev)
    for w in windows:
        _check("window", w, torch.float32, (s, n), dev)
    _check("sizes", sizes, torch.int32, (s,), dev)
    _check_lanes(n)
    resp = torch.empty((s, n), dtype=torch.float32, device=dev)
    kinds = torch.empty((s, n), dtype=torch.int32, device=dev)
    segs = [torch.empty((s, n), dtype=torch.float32, device=dev) for _ in range(n_seg)]
    counts = torch.empty((s, 4 * n_seg), dtype=torch.int32, device=dev)
    if s == 0:
        return (resp, kinds, *segs, counts)
    err = getattr(_lib(), fn_name)(
        *_ptrs(ops, params, *windows, sizes, resp, kinds, *segs, counts),
        s, n, _stream(dev),
    )
    _raise_on(err, kind)
    LAUNCHES[kind] += 1
    return (resp, kinds, *segs, counts)


def dfc_reduce_grid_call(ops, params, windows, sizes):
    """All shards' stack combines: ops i32[S,N], params f32[S,N], windows
    f32[S,N], sizes i32[S] -> (resp f32[S,N], kinds i32[S,N], segments
    f32[S,N], counts i32[S,4])."""
    if not ops.is_cuda:
        return ref.dfc_reduce_ref(ops, params, windows, sizes)
    return _ring_call("stack", "dfc_stack_reduce", ops, params, (windows,), sizes, 1)


def dfc_queue_reduce_grid_call(ops, params, windows, sizes):
    """All shards' queue combines (shapes as :func:`dfc_reduce_grid_call`)."""
    if not ops.is_cuda:
        return ref.dfc_queue_reduce_ref(ops, params, windows, sizes)
    return _ring_call("queue", "dfc_queue_reduce", ops, params, (windows,), sizes, 1)


def dfc_deque_reduce_grid_call(ops, params, windows_l, windows_r, sizes):
    """All shards' deque combines -> (resp, kinds, segs_l, segs_r, counts
    i32[S,8])."""
    if not ops.is_cuda:
        return ref.dfc_deque_reduce_ref(ops, params, windows_l, windows_r, sizes)
    return _ring_call(
        "deque", "dfc_deque_reduce", ops, params, (windows_l, windows_r), sizes, 2
    )


def dfc_map_reduce_grid_call(mkeys, mvals, mocc, counts, lkeys, ops, params):
    """All shards' map combines: tables i32/f32/i32[S,C], active counts
    i32[S], lane keys/ops i32[S,N], params f32[S,N] -> (keys', values',
    occupied' [S,C], count' i32[S], resp f32[S,N], kinds i32[S,N])."""
    if not ops.is_cuda:
        return ref.dfc_map_reduce_ref(mkeys, mvals, mocc, counts, lkeys, ops, params)
    s, c = mkeys.shape
    n = ops.shape[1]
    dev = ops.device
    bslots, n_buckets = map_geometry(c)
    _check("mkeys", mkeys, torch.int32, (s, c), dev)
    _check("mvals", mvals, torch.float32, (s, c), dev)
    _check("mocc", mocc, torch.int32, (s, c), dev)
    _check("counts", counts, torch.int32, (s,), dev)
    _check("lkeys", lkeys, torch.int32, (s, n), dev)
    _check("ops", ops, torch.int32, (s, n), dev)
    _check("params", params, torch.float32, (s, n), dev)
    keys_out = torch.empty_like(mkeys)
    vals_out = torch.empty_like(mvals)
    occ_out = torch.empty_like(mocc)
    count_out = torch.empty((s,), dtype=torch.int32, device=dev)
    resp = torch.empty((s, n), dtype=torch.float32, device=dev)
    kinds = torch.empty((s, n), dtype=torch.int32, device=dev)
    if s == 0:
        return keys_out, vals_out, occ_out, count_out, resp, kinds
    err = _lib().dfc_map_reduce(
        *_ptrs(mkeys, mvals, mocc, counts, lkeys, ops, params,
               keys_out, vals_out, occ_out, count_out, resp, kinds),
        s, c, n, bslots, n_buckets, _stream(dev),
    )
    _raise_on(err, "map")
    LAUNCHES["map"] += 1
    return keys_out, vals_out, occ_out, count_out, resp, kinds
