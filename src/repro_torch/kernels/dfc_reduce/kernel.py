"""Wrappers of the hand-written CUDA combine kernels (``csrc/``).

Two libraries, one per source:

  * ``csrc/dfc_reduce.cu`` -- one combining phase per call, one wrapper per
    kind, each the counterpart of a ``dfc_*_reduce_grid_call`` of the JAX
    package (one program instance -- here one thread block -- per shard);
  * ``csrc/phase_grid.cu`` -- K fused phases per call
    (:func:`phase_grid_call`), the counterpart of the JAX package's
    ``_phase_grid_combine`` (one thread block per shard, a loop over the
    phases inside it).

The map wrapper and :func:`phase_grid_call` make two launches per call on
the current stream: a broadcast copy of the input state into every output
row (a grid over all SMs), then the combine kernel, which writes only what
each phase changes.  For a CUDA tensor a wrapper checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``, launches
on the current stream, raises if a launch reports an error, and adds one to
its count in ``LAUNCHES`` (one per call, whatever its launches).  For a CPU tensor it returns the plain PyTorch version from
``ref.py``; there is no fallback from the card to the CPU.

The libraries are built at first use with ``nvcc`` for ``sm_90a`` -- one
``nvcc`` per source, all started together -- into ``build/dfc_reduce/`` under
the repository root (``kernels/nvcc.py``), and loaded with ``ctypes``.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.torch_dfc import STRUCTS, map_geometry
from repro_torch.kernels import nvcc
from repro_torch.kernels.dfc_reduce import ref

CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = (CSRC / "combine_common.cuh",)
LIBRARIES = (
    nvcc.Library("dfc_reduce", CSRC / "dfc_reduce.cu", _HEADERS),
    nvcc.Library("dfc_reduce", CSRC / "phase_grid.cu", _HEADERS),
)
# launches per kernel since the last reset (only real CUDA launches count):
# the one-phase kernels by kind, the K-phase kernel as phase_grid_<kind>
LAUNCHES: Dict[str, int] = {
    **{k: 0 for k in ("stack", "queue", "deque", "map")},
    **{f"phase_grid_{k}": 0 for k in ("stack", "queue", "deque", "map")},
}
# shared memory a block may use on Hopper, minus the static rank scratch
# (at most kRankInts<4>: 1 KB); the elimination buffer takes ceil(N/2)
# floats, so MAX_LANES is the largest N a ring kernel takes
_MAX_ELIM_BYTES = 232448 - 1024
MAX_LANES = 2 * (_MAX_ELIM_BYTES // 4)

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile both libraries if not yet built (see ``kernels/nvcc.py``)."""
    return nvcc.build(LIBRARIES, verbose)


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        paths = build()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib = ctypes.CDLL(str(paths["dfc_reduce"]))
        lib.dfc_stack_reduce.argtypes = [p] * 8 + [i, i, p]
        lib.dfc_queue_reduce.argtypes = [p] * 8 + [i, i, p]
        lib.dfc_deque_reduce.argtypes = [p] * 10 + [i, i, p]
        lib.dfc_map_reduce.argtypes = [p] * 13 + [i] * 5 + [p]
        fns = [getattr(lib, f"dfc_{k}_reduce") for k in ("stack", "queue", "deque", "map")]
        grid = ctypes.CDLL(str(paths["phase_grid"]))
        for k in ("stack", "queue", "deque"):
            getattr(grid, f"dfc_phase_{k}").argtypes = [p] * 10 + [i] * 4 + [p]
        grid.dfc_phase_map.argtypes = [p] * 15 + [i] * 6 + [p]
        fns += [getattr(grid, f"dfc_phase_{k}") for k in ("stack", "queue", "deque", "map")]
        for fn in fns:
            fn.restype = ctypes.c_int
        _LIBS.update(dfc_reduce=lib, phase_grid=grid)
    return _LIBS[name]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    nvcc.check_tensor(name, t, (dtype,), shape, device)


def _check_lanes(n: int) -> None:
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes exceed the kernel's shared-memory budget")


def _raise_on(err: int, kind: str) -> None:
    if err != 0:
        raise RuntimeError(f"dfc {kind} kernel launch failed: CUDA error {err}")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


_stream = nvcc.stream


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
    err = getattr(_lib("dfc_reduce"), fn_name)(
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
    err = _lib("dfc_reduce").dfc_map_reduce(
        *_ptrs(mkeys, mvals, mocc, counts, lkeys, ops, params,
               keys_out, vals_out, occ_out, count_out, resp, kinds),
        s, c, n, bslots, n_buckets, _stream(dev),
    )
    _raise_on(err, "map")
    LAUNCHES["map"] += 1
    return keys_out, vals_out, occ_out, count_out, resp, kinds


def phase_grid_call(kind: str, state, ops, params, keys):
    """K fused combining phases of one kind group: ``state`` shard-stacked
    (leading S), ``ops`` / ``keys`` i32[K,S,N], ``params`` f32[K,S,N] ->
    ``(states, resp f32[K,S,N], kinds i32[K,S,N])``, every state leaf with a
    leading K axis (the state after each phase).  The semantics are the
    vectorized ``STRUCTS[kind].combine``'s, a shard with no ops in a phase
    keeping its state and epoch."""
    if not ops.is_cuda:
        return ref.phase_grid_combine_ref(kind, state, ops, params, keys)
    k, s, n = ops.shape
    dev = ops.device
    _check("ops", ops, torch.int32, (k, s, n), dev)
    _check("params", params, torch.float32, (k, s, n), dev)
    leaves = state.leaves()
    spec = STRUCTS[kind]
    cap = leaves[0].shape[1]
    roots = {"stack": (s, 2), "queue": (s, 2, 2), "deque": (s, 2, 2)}
    if spec.keyed:
        _check("keys", keys, torch.int32, (k, s, n), dev)
        want = [("keys", torch.int32, (s, cap)), ("values", torch.float32, (s, cap)),
                ("occupied", torch.int32, (s, cap)), ("count", torch.int32, (s, 2))]
    else:
        _check_lanes(n)
        want = [("values", torch.float32, (s, cap)),
                ("root", torch.int32, roots[kind])]
    want.append(("epoch", torch.int32, (s,)))
    for leaf, (name, dtype, shape) in zip(leaves, want):
        _check(name, leaf, dtype, shape, dev)
    outs = [torch.empty((k, *leaf.shape), dtype=leaf.dtype, device=dev) for leaf in leaves]
    resp = torch.empty((k, s, n), dtype=torch.float32, device=dev)
    kinds = torch.empty((k, s, n), dtype=torch.int32, device=dev)
    if k and s:
        fn = getattr(_lib("phase_grid"), f"dfc_phase_{kind}")
        if spec.keyed:
            err = fn(*_ptrs(*leaves, keys, ops, params, *outs, resp, kinds),
                     k, s, cap, n, *map_geometry(cap), _stream(dev))
        else:
            err = fn(*_ptrs(*leaves, ops, params, *outs, resp, kinds),
                     k, s, cap, n, _stream(dev))
        _raise_on(err, f"phase-grid {kind}")
        LAUNCHES[f"phase_grid_{kind}"] += 1
    return spec.state_cls(*outs), resp, kinds
