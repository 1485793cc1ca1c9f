"""Adversarial inputs for the combine kernels, as numpy arrays from a seed.

``chip_smoke.py`` holds the CUDA kernels against their plain versions on
these at the card's sizes (up to 16,384 live lanes a shard); the CPU tests
hold the plain versions against the JAX package on the same cases at small
sizes.  Each case is ``(name, kind, leaves, keys, ops, params)``: ``leaves``
the shard-stacked state of ``S = 3`` shards in ``state_from_numpy`` order,
the lane arrays ``[K, S, N]``.  The last shard is untouched in every phase.

* ``ring_forward`` (stack, queue, deque): shard 0 alternates phases of
  mostly pushes and mostly pops, so pops read pushes of earlier phases of
  the same launch and a later phase's pushes overwrite the slots of an
  earlier one, with the ring wrapping (a queue's head near the end, a
  deque's ``left`` crossing 0); shard 1 takes random ops and foreign codes.
* ``ring_edges`` (stack, queue, deque; one phase): shard 0 alternates
  pushes and pops on an empty object, so exactly N/2 lanes are eliminated
  at an even N (a deque cycles pushL, popL, pushR, popR, so its two sides
  fill the shared elimination buffer together); shard 1 sends every lane a
  pop against a committed size of 2 (a ``-0.0`` on top), so all but two
  pops run past the window.
* ``ring_drain`` (stack, queue, deque; one phase): shard 0 holds a quarter
  of N committed (a queue's head near the ring's end) and takes about 2N/3
  pops shuffled among N/3 pushes, so one row's pops are served by the
  window, paired with this phase's pushes and run empty (a stack pairs
  first, then reads the window), the boundaries falling inside quads and,
  at the card's sizes, past the first 16,384-lane tile; shard 1 holds more
  than N committed and sends every lane a pop, so the last lane reads the
  window's last slot.
* ``map_hot``: shard 0 sends every lane to the keys of one bucket (filled
  to ``R_FULL``, then freed by deletes), a quarter of them in a run on one
  key, and reads a stored ``-0.0`` back through a lookup and a CAS; shard 1 sends every lane live with keys drawn
  from a wide universe, so its buckets outnumber a cache of some thousand
  sets, within a phase and across phases.

:func:`ring_reduce_args` and :func:`map_reduce_args` turn a case's first
phase into the one-phase kernel's arguments.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.torch_dfc import (
    CAS_DOM, OP_MAP_CAS, OP_MAP_DELETE, OP_MAP_INSERT, OP_MAP_LOOKUP, OP_NONE, OP_POP,
    OP_POPL, OP_POPR, OP_PUSH, OP_PUSHL, OP_PUSHR, map_bucket_host, map_geometry, pack_cas)

S = 3
EPOCH = np.asarray([0, 2, 4], np.int32)  # active root slots 0, 1, 0
FOREIGN = 7  # a non-zero op code no kind walks: live, but no op

Case = Tuple[str, str, List[np.ndarray], np.ndarray, np.ndarray, np.ndarray]


def _ring_ops(rng, kind, k_phases, n):
    """Shard 0: even phases mostly push, odd phases mostly pop (a deque's
    even phases push left and pop right, so right pops meet this phase's
    left pushes); shard 1: uniform codes with some foreign ones."""
    ops = np.zeros((k_phases, S, n), np.int32)
    for k in range(k_phases):
        if kind == "deque":
            codes = ([OP_PUSHL, OP_PUSHL, OP_POPR, OP_PUSHR] if k % 2 == 0
                     else [OP_POPL, OP_POPL, OP_PUSHL, OP_POPR])
        else:
            codes = [OP_PUSH] * 3 + [OP_POP] if k % 2 == 0 else [OP_POP] * 3 + [OP_PUSH]
        ops[k, 0] = rng.choice(codes, n)
        top = 5 if kind == "deque" else 3
        ops[k, 1] = rng.integers(0, top, n)
        ops[k, 1, rng.random(n) < 0.05] = FOREIGN
    return ops


def ring_forward(kind: str, k_phases: int, n: int, seed: int = 0) -> Case:
    rng = np.random.default_rng(seed)
    cap = 2 * n  # every push of a phase fits beside the committed slots
    active = (EPOCH // 2) % 2
    rows = np.arange(S)
    values = rng.integers(1, 1000, (S, cap)).astype(np.float32)
    if kind == "stack":
        root = np.zeros((S, 2), np.int32)
        root[rows, active] = [3, 5, 2]
        values[0, 2] = -0.0  # shard 0's committed top
    elif kind == "queue":
        root = np.zeros((S, 2, 2), np.int32)
        root[rows, active] = [[cap - 3, cap - 1], [4, 9], [0, 1]]  # shard 0 wraps
        values[0, cap - 3] = -0.0  # shard 0's head
    else:
        root = np.zeros((S, 2, 2), np.int32)
        root[rows, active] = [[1, 3], [-4, 2], [0, 1]]  # left pushes cross 0
        values[0, 1] = values[0, 2] = -0.0  # shard 0's two ends
    ops = _ring_ops(rng, kind, k_phases, n)
    ops[:, S - 1] = OP_NONE
    # distinct values per phase, so an overwritten slot reads differently
    params = (rng.integers(1, 1000, ops.shape)
              + 1000 * np.arange(1, k_phases + 1)[:, None, None]).astype(np.float32)
    # pushed -0.0 lands as +0.0: early lanes meet pops, late ones are surplus
    params[0, 0, :4] = params[0, 0, -4:] = -0.0
    keys = np.zeros(ops.shape, np.int32)
    return ("ring_forward", kind, [values, root, EPOCH.copy()], keys, ops, params)


def ring_edges(kind: str, n: int, seed: int = 0) -> Case:
    rng = np.random.default_rng(seed)
    cap = 2 * n
    active = (EPOCH // 2) % 2
    rows = np.arange(S)
    values = rng.integers(1, 1000, (S, cap)).astype(np.float32)
    if kind == "stack":
        root = np.zeros((S, 2), np.int32)
        root[rows, active] = [0, 2, 2]
        values[1, 1] = -0.0  # shard 1's committed top
        cycle, pops = [OP_PUSH, OP_POP], [OP_POP]
    else:
        root = np.zeros((S, 2, 2), np.int32)
        root[rows, active] = [[5, 5], [cap - 1, cap + 1], [0, 2]]  # shard 1 wraps
        values[1, cap - 1] = -0.0  # shard 1's head (queue) and left end (deque)
        if kind == "queue":
            cycle, pops = [OP_PUSH, OP_POP], [OP_POP]
        else:
            cycle, pops = [OP_PUSHL, OP_POPL, OP_PUSHR, OP_POPR], [OP_POPL, OP_POPR]
    ops = np.zeros((1, S, n), np.int32)
    ops[0, 0] = np.resize(np.asarray(cycle, np.int32), n)
    ops[0, 1] = np.resize(np.asarray(pops, np.int32), n)
    params = rng.integers(1, 1000, ops.shape).astype(np.float32)
    params[0, 0, :4] = -0.0  # pushed -0.0 lands as +0.0
    keys = np.zeros(ops.shape, np.int32)
    return ("ring_edges", kind, [values, root, EPOCH.copy()], keys, ops, params)


def ring_drain(kind: str, n: int, seed: int = 0) -> Case:
    rng = np.random.default_rng(seed)
    cap = 2 * n + 8  # shard 1 commits n + 3
    active = (EPOCH // 2) % 2
    rows = np.arange(S)
    values = rng.integers(1, 1000, (S, cap)).astype(np.float32)
    committed = n // 4
    n_pop, n_push = 2 * n // 3, n // 3  # the other lanes, if any, hold no op
    if kind == "stack":
        root = np.zeros((S, 2), np.int32)
        root[rows, active] = [committed, n + 3, 1]
        pushes, pops = [OP_PUSH], [OP_POP]
    else:
        root = np.zeros((S, 2, 2), np.int32)
        if kind == "queue":  # shard 0's window wraps past the ring's end
            head = cap - committed // 2
            pushes, pops = [OP_PUSH], [OP_POP]
        else:
            head = -(committed // 2)
            pushes, pops = [OP_PUSHL, OP_PUSHR], [OP_POPL, OP_POPR]
        root[rows, active] = [[head, head + committed], [3, n + 6], [0, 1]]
    ops = np.zeros((1, S, n), np.int32)
    row = np.zeros(n, np.int32)
    row[:n_pop] = np.resize(np.asarray(pops, np.int32), n_pop)
    row[n_pop:n_pop + n_push] = np.resize(np.asarray(pushes, np.int32), n_push)
    ops[0, 0] = rng.permutation(row)
    ops[0, 1] = np.resize(np.asarray(pops, np.int32), n)
    params = rng.integers(1, 1000, ops.shape).astype(np.float32)
    params[0, 0, :4] = -0.0  # pushed -0.0 lands as +0.0
    keys = np.zeros(ops.shape, np.int32)
    return ("ring_drain", kind, [values, root, EPOCH.copy()], keys, ops, params)


def _bucket_keys(n_buckets, bucket, count, start=1000):
    out, key = [], start
    while len(out) < count:
        cand = np.arange(key, key + 65536)
        out += [int(c) for c in cand[map_bucket_host(cand, n_buckets) == bucket]]
        key += 65536
    return out[:count]


def map_hot(k_phases: int, n: int, seed: int = 0) -> Case:
    rng = np.random.default_rng(seed)
    bslots, n_buckets = map_geometry(8 * max(64, n))
    cap = bslots * n_buckets
    active = (EPOCH // 2) % 2
    mk = np.zeros((S, cap), np.int32)
    mv = np.zeros((S, cap), np.float32)
    mo = np.zeros((S, cap), np.int32)
    count = np.zeros((S, 2), np.int32)

    def place(r, key, val):
        base = int(map_bucket_host([key], n_buckets)[0]) * bslots
        free = [j for j in range(bslots) if not mo[r, base + j]]
        if free:
            mk[r, base + free[0]], mv[r, base + free[0]], mo[r, base + free[0]] = key, val, 1
            count[r, active[r]] += 1

    hot = _bucket_keys(n_buckets, 0, bslots + 1)  # one more than the bucket holds
    for key in hot[:bslots]:
        place(0, key, float(key % 7))
    place(0, 7, -0.0)
    for key in rng.choice(1 << 20, n // 4, replace=False):
        place(1, int(key), float(key % 11))
    for key in range(40):
        place(2, key, 1.0)

    ops = rng.integers(OP_MAP_INSERT, OP_MAP_CAS + 1, (k_phases, S, n)).astype(np.int32)
    keys = np.zeros(ops.shape, np.int32)
    keys[:, 0] = rng.choice(hot, (k_phases, n))
    keys[:, 1] = rng.integers(0, 1 << 20, (k_phases, n))
    half = n // 2  # later phases find earlier keys evicted
    keys[1:, 1, :2 * half:2] = keys[:-1, 1, 1:2 * half:2]
    params = rng.integers(0, 64, ops.shape).astype(np.float32)
    cas = ops == OP_MAP_CAS
    params[cas] = (rng.integers(0, 8, int(cas.sum())) * CAS_DOM
                   + rng.integers(0, 8, int(cas.sum())))
    # shard 0, phase 0: the stored -0.0 read by a lookup, swapped by a CAS
    # that expects 0, read again; the hot bucket's ninth key is R_FULL until
    # a delete frees a slot
    lead = [(OP_MAP_LOOKUP, 7, 0.0), (OP_MAP_CAS, 7, pack_cas(0, 3)),
            (OP_MAP_LOOKUP, 7, 0.0), (OP_MAP_INSERT, hot[bslots], 5.0),
            (OP_MAP_DELETE, hot[0], 0.0), (OP_MAP_INSERT, hot[bslots], -0.0),
            (OP_MAP_LOOKUP, hot[bslots], 0.0)]
    for j, (o, key, p) in enumerate(lead[:n]):
        ops[0, 0, j], keys[0, 0, j], params[0, 0, j] = o, key, p
    # then a run of lanes on one key, as a hot key sends them
    run = slice(len(lead), min(n, len(lead) + max(8, n // 4)))
    keys[:, 0, run] = hot[1]
    shard1 = ops[:, 1]
    shard1[rng.random((k_phases, n)) < 0.02] = FOREIGN
    ops[:, S - 1] = OP_NONE
    return ("map_hot", "map", [mk, mv, mo, count, EPOCH.copy()], keys, ops, params)


def grid_cases(k_phases: int, n: int, seed: int = 0) -> List[Case]:
    """Every kind's case at ``k_phases`` phases of ``n`` lanes."""
    return [ring_forward(kind, k_phases, n, seed) for kind in ("stack", "queue", "deque")] + [
        map_hot(k_phases, n, seed)]


def ring_reduce_args(case: Case):
    """The one-phase ring kernel's arguments from a ring case's phase 0, the
    windows built from the state as the combine step builds them: (ops,
    params, window [S,N], sizes [S]), a deque's (ops, params, window_l,
    window_r, sizes)."""
    from repro_torch.core.torch_dfc import state_from_numpy
    from repro_torch.kernels.dfc_reduce import ops as O

    _, kind, leaves, _, ops, params = case
    state = state_from_numpy(kind, leaves, device="cpu")
    n = ops.shape[2]
    windows = {"stack": O._stack_window, "queue": O._queue_window,
               "deque": O._deque_windows}[kind](state, n)
    return (ops[0], params[0], *(w.numpy() for w in windows))


def map_reduce_args(case: Case):
    """The one-phase map kernel's arguments from a map case's phase 0:
    (keys, values, occupied [S,C], active count [S], lane keys, ops
    [S,N], params [S,N])."""
    _, kind, leaves, keys, ops, params = case
    assert kind == "map"
    mk, mv, mo, count, epoch = leaves
    active = (epoch // 2) % 2
    return (mk, mv, mo, count[np.arange(S), active].astype(np.int32), keys[0], ops[0],
            params[0])
