"""Combine steps built on the combine kernels: window -> kernel -> splice.

Counterpart of the JAX package's ``kernels/dfc_reduce/ops.py``.  Each ring
structure factors into a window builder (read the committed end(s) into the
kernel's lane-sized window) and a splice (apply the kernel's segments and
counts to the double-buffered state with an epoch bump of +2); the map's
whole table rides through its kernel.  Everything is batched over a leading
shard axis: states are shard-stacked, ``ops`` / ``params`` are ``[S, N]``.

``backend`` selects the combine:

  * ``"kernel"`` (the default) -- the CUDA kernels through ``kernel.py``;
    on CPU tensors those wrappers run the plain versions,
  * ``"ref"`` -- the plain versions of ``ref.py`` through the same
    window/splice (what ``chip_smoke.py`` replays the card's run with),
  * ``"torch"`` -- the vectorized ``STRUCTS[kind].combine`` (the twin of the
    JAX package's ``"jnp"`` backend).

The single-object steps are the grid kernels at S = 1.

``dfc_multi_phase_step`` fuses K phases of one kind group into one call and
returns their persist intents: ``phase_axis="scan"`` chains K one-phase
combines (one launch of the one-phase kernel per phase), ``"grid"`` runs the
K-phase kernel (one launch for all K phases, the counterpart of the JAX
package's Pallas grid over the phase axis).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.torch_dfc import (
    OP_NONE,
    STRUCTS,
    DequeState,
    PhaseIntents,
    MapState,
    QueueState,
    StackState,
    _inactive,
    _put,
    lane_of_ops,
    map_state,
    scatter_rows,
    stack_splice_values,
)
from repro_torch.kernels.dfc_reduce import kernel, ref
from repro_torch.kernels.dfc_reduce.ref import select_touched

BACKENDS = ("kernel", "ref", "torch")


def _reduce(backend: str, kernel_fn, ref_fn, *args):
    if backend == "kernel":
        return kernel_fn(*args)
    if backend == "ref":
        return ref_fn(*args)
    raise ValueError(f"unknown combine backend {backend!r}; expected one of {BACKENDS}")


# ------------------------------------------------------------------- stack
def _stack_window(state: StackState, n: int):
    """window[s] = stack_s[top-n : top], zero-padded below the bottom (the
    committed top sits at window[s, n-1])."""
    cap = state.values.shape[1]
    old_size = state.active_size()
    old = old_size.long()
    start = (old - n).clamp(0, cap - n)
    shift = torch.where(old >= n, 0, n - old)
    lanes = torch.arange(n, device=old.device)
    src = (start[:, None] + lanes - shift[:, None]).clamp(0, cap - 1)
    window = torch.where(
        lanes >= shift[:, None], state.values.gather(1, src), 0.0
    ).float()
    return window, old_size


def _stack_splice(state: StackState, segments, counts) -> StackState:
    old_size = state.active_size().long()
    n_push_surplus = counts[:, 0].long()
    n_popped = counts[:, 1].long()
    return StackState(
        values=stack_splice_values(state.values, segments, old_size, n_push_surplus),
        size=_put(state.size, _inactive(state.epoch),
                  old_size + n_push_surplus - n_popped),
        epoch=state.epoch + 2,
    )


def dfc_sharded_combine_step(state: StackState, ops, params, *, backend="kernel"):
    """Sharded stack combine: one kernel launch, one block per shard."""
    windows, sizes = _stack_window(state, ops.shape[1])
    resp, kinds, segments, counts = _reduce(
        backend, kernel.dfc_reduce_grid_call, ref.dfc_reduce_ref,
        ops, params, windows, sizes,
    )
    return _stack_splice(state, segments, counts), resp, kinds


# ------------------------------------------------------------------- queue
def _queue_window(state: QueueState, n: int):
    """Front window: queue_s[head : head+n], zero-padded past the tail."""
    cap = state.values.shape[1]
    ends = state.active_ends()
    head = ends[:, 0].long()
    size = ends[:, 1] - ends[:, 0]
    lanes = torch.arange(n, device=head.device)
    pos = torch.remainder(head[:, None] + lanes, cap)
    window = torch.where(
        lanes < size[:, None].long(), state.values.gather(1, pos), 0.0
    ).float()
    return window, size


def _queue_splice(state: QueueState, segments, counts) -> QueueState:
    n = segments.shape[1]
    cap = state.values.shape[1]
    ends = state.active_ends().long()
    head, tail = ends[:, 0], ends[:, 1]
    n_enq_surplus = counts[:, 0].long()
    n_from_q = counts[:, 1].long()
    lanes = torch.arange(n, device=head.device)
    pos = torch.remainder(tail[:, None] + lanes, cap)
    values = scatter_rows(state.values, pos, segments, lanes < n_enq_surplus[:, None])
    new_ends = torch.stack([head + n_from_q, tail + n_enq_surplus], dim=1)
    return QueueState(
        values=values,
        ends=_put(state.ends, _inactive(state.epoch), new_ends),
        epoch=state.epoch + 2,
    )


def dfc_sharded_queue_combine_step(state: QueueState, ops, params, *, backend="kernel"):
    """Sharded queue combine: front window -> kernel -> masked ring splice."""
    windows, sizes = _queue_window(state, ops.shape[1])
    resp, kinds, segments, counts = _reduce(
        backend, kernel.dfc_queue_reduce_grid_call, ref.dfc_queue_reduce_ref,
        ops, params, windows, sizes,
    )
    return _queue_splice(state, segments, counts), resp, kinds


# ------------------------------------------------------------------- deque
def _deque_windows(state: DequeState, n: int):
    """End windows seen from the left and from the right."""
    cap = state.values.shape[1]
    ends = state.active_ends()
    left, right = ends[:, 0].long(), ends[:, 1].long()
    size = ends[:, 1] - ends[:, 0]
    lanes = torch.arange(n, device=left.device)
    live = lanes < size[:, None].long()
    window_l = torch.where(
        live, state.values.gather(1, torch.remainder(left[:, None] + lanes, cap)), 0.0
    ).float()
    window_r = torch.where(
        live,
        state.values.gather(1, torch.remainder(right[:, None] - 1 - lanes, cap)),
        0.0,
    ).float()
    return window_l, window_r, size


def _deque_splice(state: DequeState, segs_l, segs_r, counts) -> DequeState:
    n = segs_l.shape[1]
    cap = state.values.shape[1]
    ends = state.active_ends().long()
    left, right = ends[:, 0], ends[:, 1]
    sl, dl, sr, dr = (counts[:, i].long() for i in range(4))
    lanes = torch.arange(n, device=left.device)
    # left pushes land at left-1-j; a negative ``left`` wraps by floor-mod
    posl = torch.remainder(left[:, None] - 1 - lanes, cap)
    values = scatter_rows(state.values, posl, segs_l, lanes < sl[:, None])
    posr = torch.remainder(right[:, None] + lanes, cap)
    values = scatter_rows(values, posr, segs_r, lanes < sr[:, None])
    new_ends = torch.stack([left - sl + dl, right + sr - dr], dim=1)
    return DequeState(
        values=values,
        ends=_put(state.ends, _inactive(state.epoch), new_ends),
        epoch=state.epoch + 2,
    )


def dfc_sharded_deque_combine_step(state: DequeState, ops, params, *, backend="kernel"):
    """Sharded deque combine: end windows -> two-sided kernel -> splices."""
    windows_l, windows_r, sizes = _deque_windows(state, ops.shape[1])
    resp, kinds, segs_l, segs_r, counts = _reduce(
        backend, kernel.dfc_deque_reduce_grid_call, ref.dfc_deque_reduce_ref,
        ops, params, windows_l, windows_r, sizes,
    )
    return _deque_splice(state, segs_l, segs_r, counts), resp, kinds


# --------------------------------------------------------------------- map
def dfc_sharded_map_combine_step(state: MapState, keys, ops, params, *, backend="kernel"):
    """Sharded map combine: the whole bucketed table rides through the
    kernel (map writes scatter by bucket, not at an end); only the
    double-buffered ``count`` is published on the inactive slot here."""
    mk, mv, mo, cnt, resp, kinds = _reduce(
        backend, kernel.dfc_map_reduce_grid_call, ref.dfc_map_reduce_ref,
        state.keys, state.values, state.occupied, state.active_count(),
        keys, ops, params,
    )
    new_state = MapState(
        keys=mk,
        values=mv.to(state.values.dtype),
        occupied=mo,
        count=_put(state.count, _inactive(state.epoch), cnt),
        epoch=state.epoch + 2,
    )
    return new_state, resp, kinds


SHARDED_COMBINE_STEPS = {
    "stack": dfc_sharded_combine_step,
    "queue": dfc_sharded_queue_combine_step,
    "deque": dfc_sharded_deque_combine_step,
}


# --------------------------------------------------------- single object
def _one_object(step, state, *arrays, backend):
    new_state, resp, kinds = step(
        map_state(lambda leaf: leaf.unsqueeze(0), state),
        *(a.unsqueeze(0) for a in arrays),
        backend=backend,
    )
    return map_state(lambda leaf: leaf[0], new_state), resp[0], kinds[0]


def dfc_combine_step(state: StackState, ops, params, *, backend="kernel"):
    """One stack's combine phase: the grid kernel at S = 1."""
    return _one_object(dfc_sharded_combine_step, state, ops, params, backend=backend)


def dfc_queue_combine_step(state: QueueState, ops, params, *, backend="kernel"):
    """One queue's combine phase: the grid kernel at S = 1."""
    return _one_object(
        dfc_sharded_queue_combine_step, state, ops, params, backend=backend
    )


def dfc_deque_combine_step(state: DequeState, ops, params, *, backend="kernel"):
    """One deque's combine phase: the grid kernel at S = 1."""
    return _one_object(
        dfc_sharded_deque_combine_step, state, ops, params, backend=backend
    )


# ----------------------------------------------------------- multi-batch
def _one_sharded_combine(kind: str, backend: str, state, ops, params, keys=None):
    """One sharded combining phase of ``kind``: the vectorized combine for
    the ``torch`` backend, one kernel launch (or its plain twin) otherwise.
    Keyed kinds consume the announced keys; ``None`` means all-zero keys
    (only valid for batches with no keyed ops)."""
    spec = STRUCTS[kind]
    if spec.keyed:
        k = torch.zeros_like(ops) if keys is None else keys
        if backend == "torch":
            return spec.combine(state, k, ops, params)
        return dfc_sharded_map_combine_step(state, k, ops, params, backend=backend)
    if backend == "torch":
        return spec.combine(state, ops, params)
    return SHARDED_COMBINE_STEPS[kind](state, ops, params, backend=backend)


# ------------------------------------------------------------ per-side lanes
def dfc_lane_combine_step(state, ops, params, *, kind, lane, backend="kernel"):
    """One per-side combining phase: only the ``lane``-side ops of each
    shard's announcement row combine (``LANE_HEAD``: the consuming side,
    ``LANE_TAIL``: the producing side); the other side's ops read as
    ``OP_NONE`` (positions kept) and answer ``R_NONE``.  The same one-phase
    kernel as any phase of ``kind``."""
    masked = torch.where(lane_of_ops(kind, ops) == lane, ops, OP_NONE)
    return _one_sharded_combine(kind, backend, state, masked, params)


def dfc_handoff_combine_step(state, ops, params, *, kind, backend="kernel"):
    """The drained handoff: both lanes' ops of a split shard in one
    combining phase, which linearizes exactly as the one-lane combine of the
    same batch (the runtime then commits both lane epochs at once)."""
    return _one_sharded_combine(kind, backend, state, ops, params)


def dfc_sharded_multi_combine_step(state, ops, params, *, kind, backend="kernel",
                                   keys=None):
    """Chain B sharded combining phases: ``ops`` / ``params`` are
    ``[B, S, N]`` and the batches apply in order (a Python loop), exactly as
    B separate combine calls would.  Shards that received no ops in a batch
    keep their state and epoch, so an all-``OP_NONE`` batch is a pure
    pass-through.  Returns ``(states, resp, kinds)``: every state leaf gains
    a leading B axis (``states`` after each batch), ``resp`` / ``kinds``
    are ``[B, S, N]``."""
    all_keys = torch.zeros_like(ops) if keys is None else keys
    carry = state
    states, resps, kinds = [], [], []
    for b in range(ops.shape[0]):
        combined, s_resp, s_kinds = _one_sharded_combine(
            kind, backend, carry, ops[b], params[b], keys=all_keys[b]
        )
        carry = select_touched((ops[b] != OP_NONE).any(1), combined, carry)
        states.append(carry)
        resps.append(s_resp)
        kinds.append(s_kinds)
    return (
        map_state(lambda *leaves: torch.stack(leaves), *states),
        torch.stack(resps),
        torch.stack(kinds),
    )


def dfc_hetero_multi_combine_step(groups, group_ops, group_params, *,
                                  backend="kernel", group_keys=None):
    """``dfc_sharded_multi_combine_step`` per kind group present
    (``group_ops[kind]`` is ``[B, S_kind, N]``).  Returns ``{kind: (states,
    resp, kinds)}``."""
    out = {}
    for kind in sorted(groups):
        out[kind] = dfc_sharded_multi_combine_step(
            groups[kind], group_ops[kind], group_params[kind],
            kind=kind, backend=backend,
            keys=None if group_keys is None else group_keys.get(kind),
        )
    return out


def dfc_hetero_combine_step(groups, group_ops, group_params, *, backend="kernel",
                            group_keys=None) -> Dict[str, tuple]:
    """Combine over a heterogeneous fabric: one launch per kind present
    (``group_ops[kind]`` is ``[S_kind, N]``), so a mixed fabric costs one
    dispatch per kind, not per shard.  Returns ``{kind: (new_state,
    resp[S_kind, N], kinds[S_kind, N])}``."""
    out = {}
    for kind in sorted(groups):
        out[kind] = _one_sharded_combine(
            kind, backend, groups[kind], group_ops[kind], group_params[kind],
            keys=None if group_keys is None else group_keys.get(kind),
        )
    return out


# ------------------------------------------------------------ K-phase fusion
def _phase_grid_combine(kind: str, backend: str, state, ops, params, keys=None):
    """K phases of one kind group through the K-phase kernel (``"kernel"``;
    its plain version on CPU tensors) or its plain version (``"ref"``).
    ``ops`` / ``params`` / ``keys`` are ``[K, S, N]``.  The vectorized
    ``"torch"`` backend has no phase grid to run on: use the scan axis."""
    if backend not in ("kernel", "ref"):
        raise ValueError(
            f"phase_axis='grid' needs the kernel or ref backend, got {backend!r}"
        )
    if keys is None:
        keys = torch.zeros_like(ops)
    if backend == "ref":
        return ref.phase_grid_combine_ref(kind, state, ops, params, keys)
    return kernel.phase_grid_call(kind, state, ops, params, keys)


def dfc_multi_phase_step(state, ops, params, *, kind, backend="kernel", unroll=1,
                         phase_axis="scan", keys=None):
    """Fuse K combining phases of one kind group into one call and return
    each phase's persist intents.

    ``ops`` / ``params`` are ``[K, S, N]``; the phases chain exactly like K
    separate sharded combine calls (an all-``OP_NONE`` phase is a pure
    pass-through), and nothing durable happens here.  ``phase_axis``:
    ``"scan"`` is :func:`dfc_sharded_multi_combine_step` (one one-phase
    launch per phase, every backend); ``"grid"`` is one K-phase launch
    (``kernel`` / ``ref`` backends).  ``unroll`` is the reference's scan
    unroll factor: PyTorch runs eagerly, so it changes nothing here.

    Returns ``(states, resp, kinds, intents)``: ``states`` with a leading K
    axis, ``resp`` / ``kinds`` ``[K, S, N]``, ``intents`` the
    :class:`PhaseIntents` record (cumulative counters start at zero).
    """
    if phase_axis == "grid":
        states, resp, kinds = _phase_grid_combine(kind, backend, state, ops, params,
                                                  keys=keys)
    elif phase_axis == "scan":
        states, resp, kinds = dfc_sharded_multi_combine_step(
            state, ops, params, kind=kind, backend=backend, keys=keys
        )
    else:
        raise ValueError(f"unknown phase_axis {phase_axis!r}")
    live = ops != OP_NONE
    touched = live.any(2)  # bool[K, S]
    intents = PhaseIntents(
        epoch=states.epoch.to(torch.int32),
        touched=touched,
        phases_cum=touched.int().cumsum(0, dtype=torch.int32),
        ops_cum=live.int().sum(2, dtype=torch.int32).cumsum(0, dtype=torch.int32),
    )
    return states, resp, kinds, intents


def dfc_hetero_multi_phase_step(groups, group_ops, group_params, *, backend="kernel",
                                unroll=1, phase_axis="scan", group_keys=None):
    """:func:`dfc_multi_phase_step` per kind group present
    (``group_ops[kind]`` is ``[K, S_kind, N]``).  Returns ``{kind: (states,
    resp, kinds, intents)}``."""
    out = {}
    for kind in sorted(groups):
        out[kind] = dfc_multi_phase_step(
            groups[kind], group_ops[kind], group_params[kind],
            kind=kind, backend=backend, unroll=unroll, phase_axis=phase_axis,
            keys=None if group_keys is None else group_keys.get(kind),
        )
    return out
