"""The paper's combiners as data-parallel PyTorch ops.

Counterpart of the JAX package's ``core/jax_dfc.py``.  The same four
array-backed structures, with double-buffered roots and a one-pass
vectorized ``combine``:

  * stack: ``values[capacity]`` + two alternating ``size`` pointers,
  * queue: a ring ``values[capacity]`` + double-buffered ``(head, tail)``
    absolute counters (``ends[2, 2]``); slot = counter % capacity,
  * deque: the same ring with double-buffered ``(left, right)`` counters,
  * map: a bucketed hash table whose live-entry ``count`` is double-buffered.

A combining phase writes only outside the committed window and publishes by
writing the inactive root with an epoch bump of +2, so a crash mid-combine
leaves the committed state intact.

PyTorch idiom: a state is a plain dataclass of tensors whose ``leaves()``
come in field order (the order the durable layer saves them in).  Every
function here takes either one object (``ops`` of shape ``[N]``) or a
shard-stacked batch of objects (every state leaf with a leading shard axis,
``ops`` of shape ``[S, N]``): the batch dimension is written out, there is no
``vmap``.  Values are routed with indexed loads and stores (scatter into a
zeroed row, so a pushed ``-0.0`` comes back as ``+0.0`` exactly as the
reference's one-hot route gives it).  Every state leaf stays ``int32`` /
``float32``: PyTorch's integer reductions default to ``int64``, so results
are cast back before they reach a state.

Linearization of a combined batch (the witness shared with the
``sequential_reference*`` oracles): eliminated pairs first, then the surplus
in rank order; the map applies its lanes in announcement order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

# op codes (stack/queue: enq==push, deq==pop)
OP_NONE = 0
OP_PUSH = 1
OP_POP = 2
OP_ENQ = OP_PUSH
OP_DEQ = OP_POP
# deque op codes
OP_PUSHL = 1
OP_POPL = 2
OP_PUSHR = 3
OP_POPR = 4
# serving-tier aliases: priority admission runs a request shard as a deque --
# a normal arrival joins the BACK of the line (pushR), admission drains the
# FRONT (popL), and a high-priority arrival jumps the line (pushL).
# OP_POP_FRONT == OP_DEQ == 2, so one admission op code serves both queue
# and deque request shards.
OP_PUSH_BACK = OP_PUSHR
OP_PUSH_FRONT = OP_PUSHL
OP_POP_FRONT = OP_POPL
# response kinds
R_NONE = 0
R_ACK = 1
R_VALUE = 2
R_EMPTY = 3
# keyed-map op codes
OP_MAP_INSERT = 1
OP_MAP_LOOKUP = 2
OP_MAP_DELETE = 3
OP_MAP_CAS = 4
# map rejections start at 5: code 4 is the runtime's R_OVERFLOW
R_FULL = 5  # insert into a full bucket: clean rejection, no write
R_CAS_FAIL = 6  # CAS found the key but the expected value did not match
# OP_MAP_CAS packs (expected, new) into ONE f32 param as
# ``expected * CAS_DOM + new``; CAS_DOM**2 - 1 == 2**24 - 1 is the top of
# f32's contiguous-integer range, so the packing is lossless.
CAS_DOM = 4096
# slots per hash bucket of a map shard (the fixed probe window)
MAP_BUCKET_SLOTS = 8

# announcement lanes of two-sided structures (per-side combiners)
LANE_NONE = -1
LANE_HEAD = 0
LANE_TAIL = 1

_HASH_MIX_1 = 2654435761
_HASH_MIX_2 = 2246822519
_U32 = 0xFFFFFFFF


def pack_cas(expected: int, new: int) -> float:
    """Pack a CAS ``(expected, new)`` pair into one f32-exact op param.

    Both operands must sit in ``[0, CAS_DOM)``: the combine unpacks with
    floor-divide, so an out-of-range operand would wrap silently into the
    other field.
    """
    expected, new = int(expected), int(new)
    if not 0 <= expected < CAS_DOM:
        raise ValueError(f"CAS expected value {expected} outside [0, {CAS_DOM})")
    if not 0 <= new < CAS_DOM:
        raise ValueError(f"CAS new value {new} outside [0, {CAS_DOM})")
    packed = expected * CAS_DOM + new
    assert packed < CAS_DOM * CAS_DOM and float(np.float32(packed)) == packed
    return float(packed)


def unpack_cas(packed) -> Tuple[int, int]:
    """Invert :func:`pack_cas` -> ``(expected, new)``."""
    p = int(packed)
    if not 0 <= p < CAS_DOM * CAS_DOM:
        raise ValueError(f"packed CAS param {p} outside [0, {CAS_DOM ** 2})")
    return p // CAS_DOM, p % CAS_DOM


# ================================================================ state base
class _State:
    """Shared helpers of the structure dataclasses."""

    def leaves(self) -> List[torch.Tensor]:
        """The state's tensors in dataclass field order."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @property
    def active_idx(self) -> torch.Tensor:
        return (self.epoch // 2) % 2


def map_state(fn: Callable[..., torch.Tensor], *states):
    """Apply ``fn`` leaf-wise across states of one class (``tree_map``)."""
    cls = type(states[0])
    return cls(*[fn(*ls) for ls in zip(*(s.leaves() for s in states))])


def _pick(pair: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pair[..., idx, ...]`` of a double-buffered root: ``pair`` is
    ``[*B, 2]`` (sizes, counts) or ``[*B, 2, 2]`` (ends), ``idx`` is ``[*B]``."""
    i = idx.long()
    if pair.dim() == i.dim() + 1:
        return pair.gather(-1, i.unsqueeze(-1)).squeeze(-1)
    g = i[..., None, None].expand(*i.shape, 1, pair.shape[-1])
    return pair.gather(-2, g).squeeze(-2)


def _put(pair: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``pair.at[..., idx].set(val)`` (see :func:`_pick`)."""
    i = idx.long()
    v = val.to(pair.dtype)
    if pair.dim() == i.dim() + 1:
        return pair.scatter(-1, i.unsqueeze(-1), v.unsqueeze(-1))
    g = i[..., None, None].expand(*i.shape, 1, pair.shape[-1])
    return pair.scatter(-2, g, v.unsqueeze(-2))


def _inactive(epoch: torch.Tensor) -> torch.Tensor:
    return (epoch // 2 + 1) % 2


@dataclasses.dataclass
class StackState(_State):
    """Array-backed DFC stack with double-buffered top (paper Fig 1)."""

    values: torch.Tensor  # f32[..., capacity]
    size: torch.Tensor  # i32[..., 2] — two alternating stack sizes
    epoch: torch.Tensor  # i32[...] — cEpoch (always even between phases)

    def active_size(self) -> torch.Tensor:
        return _pick(self.size, self.active_idx)


@dataclasses.dataclass
class QueueState(_State):
    """Ring-backed DFC queue with double-buffered (head, tail) counters;
    the occupied window is [head, tail), slot = counter % capacity."""

    values: torch.Tensor  # f32[..., capacity] ring
    ends: torch.Tensor  # i32[..., 2, 2] — two alternating (head, tail) pairs
    epoch: torch.Tensor  # i32[...]

    def active_ends(self) -> torch.Tensor:
        return _pick(self.ends, self.active_idx)

    def active_size(self) -> torch.Tensor:
        e = self.active_ends()
        return e[..., 1] - e[..., 0]


@dataclasses.dataclass
class DequeState(_State):
    """Ring-backed DFC deque with double-buffered (left, right) counters;
    counters may go negative (floor-mod keeps slots in range)."""

    values: torch.Tensor  # f32[..., capacity] ring
    ends: torch.Tensor  # i32[..., 2, 2] — two alternating (left, right) pairs
    epoch: torch.Tensor  # i32[...]

    def active_ends(self) -> torch.Tensor:
        return _pick(self.ends, self.active_idx)

    def active_size(self) -> torch.Tensor:
        e = self.active_ends()
        return e[..., 1] - e[..., 0]


@dataclasses.dataclass
class MapState(_State):
    """Bucketed-hash DFC map with a double-buffered entry count.

    Slot ``i`` belongs to bucket ``i // bslots``; a key lives only in its
    hash bucket, and an insert into a bucket with no free slot is a clean
    ``R_FULL`` rejection.  The table is mutated in place by a phase (its
    durability comes from the runtime's alternating slot snapshots); only
    ``count`` is double-buffered by epoch parity.
    """

    keys: torch.Tensor  # i32[..., capacity]
    values: torch.Tensor  # f32[..., capacity]
    occupied: torch.Tensor  # i32[..., capacity] — 0/1 per slot
    count: torch.Tensor  # i32[..., 2] — two alternating live-entry counts
    epoch: torch.Tensor  # i32[...]

    def active_count(self) -> torch.Tensor:
        return _pick(self.count, self.active_idx)


def init_stack(capacity: int, dtype=torch.float32, device="cuda") -> StackState:
    return StackState(
        values=torch.zeros((capacity,), dtype=dtype, device=device),
        size=torch.zeros((2,), dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_queue(capacity: int, dtype=torch.float32, device="cuda") -> QueueState:
    return QueueState(
        values=torch.zeros((capacity,), dtype=dtype, device=device),
        ends=torch.zeros((2, 2), dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_deque(capacity: int, dtype=torch.float32, device="cuda") -> DequeState:
    return DequeState(
        values=torch.zeros((capacity,), dtype=dtype, device=device),
        ends=torch.zeros((2, 2), dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def map_geometry(capacity: int) -> Tuple[int, int]:
    """(slots per bucket, bucket count) of a map shard of ``capacity``."""
    bslots = min(capacity, MAP_BUCKET_SLOTS)
    if capacity % bslots != 0:
        raise ValueError(
            f"map capacity {capacity} not a multiple of bucket width {bslots}"
        )
    return bslots, capacity // bslots


def init_map(capacity: int, dtype=torch.float32, device="cuda") -> MapState:
    map_geometry(capacity)  # validate up front
    return MapState(
        keys=torch.zeros((capacity,), dtype=torch.int32, device=device),
        values=torch.zeros((capacity,), dtype=dtype, device=device),
        occupied=torch.zeros((capacity,), dtype=torch.int32, device=device),
        count=torch.zeros((2,), dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


# ============================================================ int32 hashing
def to_int32(x) -> torch.Tensor:
    """Cut integers to 32 bits with two's-complement wrap, the way the JAX
    reference sees keys (it runs with 64-bit types off)."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if t.dtype == torch.int32:
        return t
    t = t.long() & _U32
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def _mul_u32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2^32`` for ``a`` in [0, 2^32) held in int64, without an
    int64 overflow: split ``m`` into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _as_u32(keys) -> torch.Tensor:
    return to_int32(keys).long() & _U32


def map_bucket(keys, n_buckets: int) -> torch.Tensor:
    """Bucket of each key inside ONE map shard: a second multiplicative mix,
    decorrelated from the router's shard hash.  uint32 arithmetic, carried
    in int64 masked to 32 bits."""
    h = _mul_u32(_as_u32(keys), _HASH_MIX_1)
    h = h ^ (h >> 16)
    h = _mul_u32(h, _HASH_MIX_2)
    h = h ^ (h >> 13)
    return (h % n_buckets).to(torch.int32)


def map_bucket_host(keys, n_buckets: int) -> np.ndarray:
    """NumPy twin of :func:`map_bucket` for host-side oracles and rebuilds;
    keys are cut to 32 bits first, as the device sees them (so a negative
    key hashes as its two's-complement bits)."""
    k = (np.asarray(keys).astype(np.int64) & _U32).astype(np.uint64)
    h = (k * _HASH_MIX_1) & _U32
    h = h ^ (h >> 16)
    h = (h * _HASH_MIX_2) & _U32
    h = h ^ (h >> 13)
    return (h % n_buckets).astype(np.int32)


# ======================================================= batched building blocks
def _batched(fn):
    """Run a shard-batched combine on one object too: a 1-D ``ops`` gains a
    leading shard axis of one, and the results lose it again."""

    def wrapper(state, *arrays):
        if arrays[0].dim() == 2:
            return fn(state, *arrays)
        new_state, resp, kinds = fn(
            map_state(lambda leaf: leaf.unsqueeze(0), state),
            *(a.unsqueeze(0) for a in arrays),
        )
        return map_state(lambda leaf: leaf[0], new_state), resp[0], kinds[0]

    return functools.wraps(fn)(wrapper)


def exclusive_rank(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each set lane among the set lanes of its row (-1 elsewhere):
    an exclusive prefix sum along the last axis, in int64."""
    return torch.where(mask, mask.long().cumsum(-1) - 1, -1)


def route_rows(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s, idx[s, j]] = vals[s, j]`` into a zeroed ``[S, n]`` row;
    indices outside ``[0, n)`` drop into a sink column.  The row starts at
    ``+0.0``, so a routed ``-0.0`` lands as ``+0.0`` (scatter-add)."""
    s = idx.shape[0]
    out = torch.zeros((s, n + 1), dtype=torch.float32, device=vals.device)
    safe = torch.where((idx >= 0) & (idx < n), idx, n)
    out.scatter_add_(1, safe.long(), vals.float())
    return out[:, :n]


def scatter_rows(dst: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor,
                 write: torch.Tensor) -> torch.Tensor:
    """Out-of-place masked row scatter ``dst.at[s, pos].set(vals)`` where
    ``write`` holds (``mode="drop"`` elsewhere).  Lanes that do not write
    store the slot's own value back, so no sink column is needed; ``pos``
    must be distinct within a row (true whenever lanes <= capacity)."""
    p = pos.long()
    old = dst.gather(1, p)
    return dst.scatter(1, p, torch.where(write, vals.to(dst.dtype), old))


def stack_splice_values(values, segment, old_size, n_push_surplus):
    """The stack's surplus-push splice: ``segment`` lands at
    ``clip(old_size, 0, cap - n)`` and only ``[old_size, old_size + sp)``
    of it is kept (contract: capacity >= size + N)."""
    n = segment.shape[1]
    cap = values.shape[1]
    old = old_size.long()
    start = old.clamp(0, cap - n)
    lanes = torch.arange(n, device=values.device)
    pos = start[:, None] + lanes
    keep = (pos >= old[:, None]) & (pos < (old + n_push_surplus.long())[:, None])
    return scatter_rows(values, pos, segment, keep)


# ====================================================================== stack
@_batched
def combine(state: StackState, ops, params):
    """One DFC combining phase over N announcement lanes.

    Returns (new_state, responses f32[N], kinds i32[N]).
    """
    n = ops.shape[1]
    cap = state.values.shape[1]
    params = params.float()

    is_push = ops == OP_PUSH
    is_pop = ops == OP_POP
    push_rank = exclusive_rank(is_push)
    pop_rank = exclusive_rank(is_pop)
    p_total = is_push.sum(1)
    q_total = is_pop.sum(1)
    n_elim = torch.minimum(p_total, q_total)
    ne = n_elim[:, None]

    old_size = state.active_size().long()

    # --- elimination: pop_k gets push_k's param -----------------------------
    push_by_rank = route_rows(push_rank, params, n)
    elim_pop_val = push_by_rank.gather(1, pop_rank.clamp(0, n - 1))

    # --- surplus pushes: compact above the committed prefix -----------------
    surplus_push = is_push & (push_rank >= ne)
    segment = route_rows(torch.where(surplus_push, push_rank - ne, n), params, n)
    n_push_surplus = (p_total - n_elim).clamp_min(0)
    new_values = stack_splice_values(state.values, segment, old_size, n_push_surplus)

    # --- surplus pops: read below the committed prefix ----------------------
    surplus_pop = is_pop & (pop_rank >= ne)
    pop_src = old_size[:, None] - 1 - (pop_rank - ne)
    pop_ok = surplus_pop & (pop_src >= 0)
    stack_val = state.values.gather(1, pop_src.clamp(0, cap - 1)).float()

    # --- responses -----------------------------------------------------------
    elim = is_pop & (pop_rank < ne)
    kinds = torch.full_like(ops, R_NONE, dtype=torch.int32)
    kinds = torch.where(is_push, R_ACK, kinds)
    kinds = torch.where(elim | pop_ok, R_VALUE, kinds)
    kinds = torch.where(surplus_pop & ~pop_ok, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(elim, elim_pop_val, resp)
    resp = torch.where(pop_ok, stack_val, resp)

    # --- publish: write the inactive size, bump epoch by 2 -------------------
    n_popped = torch.minimum((q_total - n_elim).clamp_min(0), old_size)
    new_size_val = old_size + n_push_surplus - n_popped
    new_state = StackState(
        values=new_values,
        size=_put(state.size, _inactive(state.epoch), new_size_val),
        epoch=state.epoch + 2,
    )
    return new_state, resp, kinds



def sequential_reference(stack_list, ops, params):
    """Canonical linearization witness in pure Python (test oracle):
    eliminated pairs, then surplus pushes, then surplus pops."""
    n = len(ops)
    pushes = [i for i in range(n) if ops[i] == OP_PUSH]
    pops = [i for i in range(n) if ops[i] == OP_POP]
    e = min(len(pushes), len(pops))
    responses = [0.0] * n
    kinds = [R_NONE] * n
    stack = list(stack_list)
    for k in range(e):  # eliminated pairs
        kinds[pushes[k]] = R_ACK
        kinds[pops[k]] = R_VALUE
        responses[pops[k]] = float(params[pushes[k]])
    for i in pushes[e:]:  # surplus pushes
        stack.append(float(params[i]))
        kinds[i] = R_ACK
    for i in pops[e:]:  # surplus pops
        if stack:
            responses[i] = stack.pop()
            kinds[i] = R_VALUE
        else:
            kinds[i] = R_EMPTY
    return stack, responses, kinds


# ====================================================================== queue
@_batched
def combine_queue(state: QueueState, ops, params):
    """One DFC queue combining phase over N announcement lanes.

    Dequeues drain the committed window FIFO; once drained, deq rank size+k
    pairs with enq rank k (two-sided elimination); surplus enqueues append
    in rank order; deqs beyond every enqueue return EMPTY.

    Returns (new_state, responses f32[N], kinds i32[N]).
    """
    n = ops.shape[1]
    cap = state.values.shape[1]
    params = params.float()
    ends = state.active_ends().long()
    head, tail = ends[:, 0], ends[:, 1]
    size = tail - head
    sz = size[:, None]

    is_enq = ops == OP_ENQ
    is_deq = ops == OP_DEQ
    enq_rank = exclusive_rank(is_enq)
    deq_rank = exclusive_rank(is_deq)
    p_total = is_enq.sum(1)
    q_total = is_deq.sum(1)
    n_from_q = torch.minimum(q_total, size)
    n_elim = torch.minimum((q_total - size).clamp_min(0), p_total)
    ne = n_elim[:, None]

    # --- deqs served FIFO from the committed window -------------------------
    served = is_deq & (deq_rank < sz)
    ring_val = state.values.gather(
        1, torch.remainder(head[:, None] + deq_rank.clamp_min(0), cap)
    ).float()

    # --- drained: deq rank size+k pairs with enq rank k ---------------------
    enq_by_rank = route_rows(enq_rank, params, n)
    paired = is_deq & (deq_rank >= sz) & (deq_rank - sz < ne)
    pair_val = enq_by_rank.gather(1, (deq_rank - sz).clamp(0, n - 1))
    empty = is_deq & (deq_rank >= sz + ne)

    # --- surplus enqs append at the tail ------------------------------------
    surplus_enq = is_enq & (enq_rank >= ne)
    n_enq_surplus = p_total - n_elim
    segment = route_rows(torch.where(surplus_enq, enq_rank - ne, n), params, n)
    lanes = torch.arange(n, device=ops.device)
    pos = torch.remainder(tail[:, None] + lanes, cap)
    new_values = scatter_rows(
        state.values, pos, segment, lanes < n_enq_surplus[:, None]
    )

    # --- responses -----------------------------------------------------------
    kinds = torch.full_like(ops, R_NONE, dtype=torch.int32)
    kinds = torch.where(is_enq, R_ACK, kinds)
    kinds = torch.where(served | paired, R_VALUE, kinds)
    kinds = torch.where(empty, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(served, ring_val, resp)
    resp = torch.where(paired, pair_val, resp)

    # --- publish: write the inactive (head, tail), bump epoch by 2 -----------
    new_ends = torch.stack([head + n_from_q, tail + n_enq_surplus], dim=1)
    new_state = QueueState(
        values=new_values,
        ends=_put(state.ends, _inactive(state.epoch), new_ends),
        epoch=state.epoch + 2,
    )
    return new_state, resp, kinds



def sequential_reference_queue(queue_list, ops, params):
    """Canonical queue linearization witness in pure Python (test oracle)."""
    n = len(ops)
    enqs = [i for i in range(n) if ops[i] == OP_ENQ]
    deqs = [i for i in range(n) if ops[i] == OP_DEQ]
    responses = [0.0] * n
    kinds = [R_NONE] * n
    q = list(queue_list)
    for i in enqs:
        kinds[i] = R_ACK
    di = 0
    while di < len(deqs) and q:  # serve from the committed queue
        responses[deqs[di]] = q.pop(0)
        kinds[deqs[di]] = R_VALUE
        di += 1
    ei = 0
    while di < len(deqs) and ei < len(enqs):  # eliminated pairs
        responses[deqs[di]] = float(params[enqs[ei]])
        kinds[deqs[di]] = R_VALUE
        di += 1
        ei += 1
    while di < len(deqs):
        kinds[deqs[di]] = R_EMPTY
        di += 1
    for i in enqs[ei:]:  # surplus enqueues
        q.append(float(params[i]))
    return q, responses, kinds


# ====================================================================== deque
@_batched
def combine_deque(state: DequeState, ops, params):
    """One DFC deque combining phase over N announcement lanes.

    Same-side eliminated pairs first (state untouched), then the LEFT
    surplus in rank order, then the RIGHT surplus in rank order; right
    surplus pops may consume values pushed left in the same phase.

    Returns (new_state, responses f32[N], kinds i32[N]).
    """
    n = ops.shape[1]
    cap = state.values.shape[1]
    params = params.float()
    ends = state.active_ends().long()
    left, right = ends[:, 0], ends[:, 1]
    size = right - left
    sz = size[:, None]
    lanes = torch.arange(n, device=ops.device)

    is_pl = ops == OP_PUSHL
    is_ql = ops == OP_POPL
    is_pr = ops == OP_PUSHR
    is_qr = ops == OP_POPR
    pl_rank, ql_rank = exclusive_rank(is_pl), exclusive_rank(is_ql)
    pr_rank, qr_rank = exclusive_rank(is_pr), exclusive_rank(is_qr)
    npl, nql = is_pl.sum(1), is_ql.sum(1)
    npr, nqr = is_pr.sum(1), is_qr.sum(1)
    nl_elim = torch.minimum(npl, nql)
    nr_elim = torch.minimum(npr, nqr)
    nle, nre = nl_elim[:, None], nr_elim[:, None]

    # --- same-side elimination: pop_k gets push_k's param -------------------
    pl_by_rank = route_rows(pl_rank, params, n)
    pr_by_rank = route_rows(pr_rank, params, n)
    eliml = is_ql & (ql_rank < nle)
    elimr = is_qr & (qr_rank < nre)
    eliml_val = pl_by_rank.gather(1, ql_rank.clamp(0, n - 1))
    elimr_val = pr_by_rank.gather(1, qr_rank.clamp(0, n - 1))

    # --- left surplus (pushes XOR pops) -------------------------------------
    sl = (npl - nl_elim).clamp_min(0)
    tl = (nql - nl_elim).clamp_min(0)
    surplus_pl = is_pl & (pl_rank >= nle)
    seg_l = route_rows(torch.where(surplus_pl, pl_rank - nle, n), params, n)
    # push j lands at slot left-1-j (later pushes further left)
    posl = torch.remainder(left[:, None] - 1 - lanes, cap)
    vals1 = scatter_rows(state.values, posl, seg_l, lanes < sl[:, None])
    dl = torch.minimum(tl, size)
    surplus_ql = is_ql & (ql_rank >= nle)
    kl = ql_rank - nle
    lpop_ok = surplus_ql & (kl < sz)
    lpop_val = state.values.gather(
        1, torch.remainder(left[:, None] + kl.clamp_min(0), cap)
    ).float()
    size_after = size + sl - dl

    # --- right surplus (pushes XOR pops), applied after the left ------------
    sr = (npr - nr_elim).clamp_min(0)
    tr = (nqr - nr_elim).clamp_min(0)
    surplus_pr = is_pr & (pr_rank >= nre)
    seg_r = route_rows(torch.where(surplus_pr, pr_rank - nre, n), params, n)
    posr = torch.remainder(right[:, None] + lanes, cap)
    new_values = scatter_rows(vals1, posr, seg_r, lanes < sr[:, None])
    dr = torch.minimum(tr, size_after)
    surplus_qr = is_qr & (qr_rank >= nre)
    kr = qr_rank - nre
    rpop_ok = surplus_qr & (kr < size_after[:, None])
    # right pop k reads slot right-1-k: committed when k < size, otherwise a
    # value pushed left in this phase (vals1 holds both)
    rpop_val = vals1.gather(
        1, torch.remainder(right[:, None] - 1 - kr.clamp_min(0), cap)
    ).float()

    # --- responses -----------------------------------------------------------
    kinds = torch.full_like(ops, R_NONE, dtype=torch.int32)
    kinds = torch.where(is_pl | is_pr, R_ACK, kinds)
    kinds = torch.where(eliml | elimr | lpop_ok | rpop_ok, R_VALUE, kinds)
    kinds = torch.where(surplus_ql & ~lpop_ok, R_EMPTY, kinds)
    kinds = torch.where(surplus_qr & ~rpop_ok, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(eliml, eliml_val, resp)
    resp = torch.where(elimr, elimr_val, resp)
    resp = torch.where(lpop_ok, lpop_val, resp)
    resp = torch.where(rpop_ok, rpop_val, resp)

    # --- publish: write the inactive (left, right), bump epoch by 2 ----------
    new_ends = torch.stack([left - sl + dl, right + sr - dr], dim=1)
    new_state = DequeState(
        values=new_values,
        ends=_put(state.ends, _inactive(state.epoch), new_ends),
        epoch=state.epoch + 2,
    )
    return new_state, resp, kinds



def sequential_reference_deque(deque_list, ops, params):
    """Canonical deque linearization witness in pure Python (test oracle)."""
    n = len(ops)
    pl = [i for i in range(n) if ops[i] == OP_PUSHL]
    ql = [i for i in range(n) if ops[i] == OP_POPL]
    pr = [i for i in range(n) if ops[i] == OP_PUSHR]
    qr = [i for i in range(n) if ops[i] == OP_POPR]
    nl = min(len(pl), len(ql))
    nr = min(len(pr), len(qr))
    responses = [0.0] * n
    kinds = [R_NONE] * n
    d = list(deque_list)
    for k in range(nl):  # same-side eliminated pairs
        kinds[pl[k]] = R_ACK
        kinds[ql[k]] = R_VALUE
        responses[ql[k]] = float(params[pl[k]])
    for k in range(nr):
        kinds[pr[k]] = R_ACK
        kinds[qr[k]] = R_VALUE
        responses[qr[k]] = float(params[pr[k]])
    for i in pl[nl:]:  # left surplus first…
        d.insert(0, float(params[i]))
        kinds[i] = R_ACK
    for i in ql[nl:]:
        if d:
            responses[i] = d.pop(0)
            kinds[i] = R_VALUE
        else:
            kinds[i] = R_EMPTY
    for i in pr[nr:]:  # …then right surplus
        d.append(float(params[i]))
        kinds[i] = R_ACK
    for i in qr[nr:]:
        if d:
            responses[i] = d.pop()
            kinds[i] = R_VALUE
        else:
            kinds[i] = R_EMPTY
    return d, responses, kinds


# ======================================================================== map
def map_live_lanes(ops) -> list:
    """The lanes (columns of ``ops`` ``[S, N]``) where some shard holds a
    map op, in announcement order.  A map walk need visit no other lane:
    at a lane without one :func:`map_lane_apply` writes nothing and answers
    ``(+0.0, R_NONE)`` in every shard, what the walk's zeroed outputs hold
    already.  A routed batch fills each shard's lanes from lane 0, so past
    the busiest shard's count no lane is live."""
    live = ((ops >= OP_MAP_INSERT) & (ops <= OP_MAP_CAS)).any(0)
    return live.nonzero().flatten().tolist()


def map_lane_apply(mk, mv, mo, cnt, key, op, par, *, summed_cur: bool):
    """Apply ONE keyed lane to every shard's table (``[S, C]`` rows, ``key``
    / ``op`` / ``par`` of shape ``[S]``), in place.

    The lane probes only its key's bucket window of ``bslots`` slots.  A hit
    needs the occupied flag (key 0 is legal); the first hit or first free
    slot of the window is taken (offset 0 when there is none, which no write
    then uses).  ``summed_cur`` reads the hit value as the masked sum over
    the window, as the kernel's plain twin does (a stored ``-0.0`` reads as
    ``+0.0``); otherwise it is the hit slot's own value, as the vectorized
    combine reads it.  Returns ``(cnt', resp[S], kind[S])``.
    """
    cap = mk.shape[1]
    bslots, n_buckets = map_geometry(cap)
    win = torch.arange(bslots, device=mk.device)
    base = map_bucket(key, n_buckets).long() * bslots
    idx = base[:, None] + win
    wk, wv, wo = mk.gather(1, idx), mv.gather(1, idx), mo.gather(1, idx)
    occ = wo != 0
    hit = occ & (wk == key[:, None])
    has_hit = hit.any(1)
    hit_off = hit.int().argmax(1)
    free = ~occ
    has_free = free.any(1)
    free_off = free.int().argmax(1)
    if summed_cur:
        masked = torch.where(hit, wv, 0.0)
        # a one-slot window is its own sum (a stored -0.0 stays -0.0)
        cur = masked[:, 0] if bslots == 1 else masked.sum(1)
    else:
        cur = wv.gather(1, hit_off[:, None])[:, 0].float()

    is_ins = op == OP_MAP_INSERT
    is_lku = op == OP_MAP_LOOKUP
    is_del = op == OP_MAP_DELETE
    is_cas = op == OP_MAP_CAS
    expected = torch.floor(par / CAS_DOM)
    cas_new = par - expected * CAS_DOM
    cas_hit = is_cas & has_hit
    cas_ok = cas_hit & (cur == expected)

    do_ins = is_ins & (has_hit | has_free)
    do_del = is_del & has_hit
    do_write = do_ins | cas_ok
    woff = torch.where(has_hit, hit_off, free_off)
    slot = (base + woff.long())[:, None]
    wval = torch.where(is_cas, cas_new, par)
    touch = (do_write | do_del)[:, None]
    mk.scatter_(1, slot, torch.where(
        touch, torch.where(do_write, key, 0)[:, None], mk.gather(1, slot)))
    mv.scatter_(1, slot, torch.where(
        touch, torch.where(do_write, wval, 0.0)[:, None].to(mv.dtype),
        mv.gather(1, slot)))
    mo.scatter_(1, slot, torch.where(
        touch, do_write.to(mo.dtype)[:, None], mo.gather(1, slot)))
    cnt = cnt + (is_ins & ~has_hit & has_free).int() - do_del.int()

    kind = torch.full_like(op, R_NONE)
    kind = torch.where(do_ins, R_ACK, kind)
    kind = torch.where(is_ins & ~has_hit & ~has_free, R_FULL, kind)
    kind = torch.where((is_lku | is_del | is_cas) & ~has_hit, R_EMPTY, kind)
    kind = torch.where((is_lku | do_del | cas_ok) & has_hit, R_VALUE, kind)
    kind = torch.where(cas_hit & ~cas_ok, R_CAS_FAIL, kind)
    resp = torch.where((is_lku | is_del | is_cas) & has_hit, cur, 0.0)
    return cnt.to(torch.int32), resp.float(), kind.to(torch.int32)


@_batched
def combine_map(state: MapState, keys, ops, params):
    """One DFC map combining phase over N keyed announcement lanes.

    Map ops do not commute, so there is no elimination: lanes apply in
    announcement order (a loop over the live lanes, ``map_live_lanes``,
    vectorized over shards).  Per
    lane: insert overwrites a hit or takes a free slot (``R_ACK``) or is
    rejected ``R_FULL``; lookup returns the value (``R_VALUE``) or
    ``R_EMPTY``; delete clears the slot and returns the old value; CAS
    writes ``new`` when the value equals ``expected`` (``R_VALUE``, old
    value), else ``R_CAS_FAIL`` (current value), ``R_EMPTY`` on a miss.

    Returns (new_state, responses f32[N], kinds i32[N]).
    """
    s, n = ops.shape
    mk = state.keys.clone()
    mv = state.values.clone()
    mo = state.occupied.clone()
    cnt = state.active_count()
    keys32 = to_int32(keys).to(ops.device)
    params = params.float()
    resp = torch.zeros((s, n), dtype=torch.float32, device=ops.device)
    kinds = torch.zeros((s, n), dtype=torch.int32, device=ops.device)
    for j in map_live_lanes(ops):
        cnt, resp[:, j], kinds[:, j] = map_lane_apply(
            mk, mv, mo, cnt, keys32[:, j], ops[:, j].int(), params[:, j],
            summed_cur=False,
        )
    new_state = MapState(
        keys=mk, values=mv, occupied=mo,
        count=_put(state.count, _inactive(state.epoch), cnt),
        epoch=state.epoch + 2,
    )
    return new_state, resp, kinds


def sequential_reference_map(entries, keys, ops, params, capacity=None):
    """Canonical map linearization witness in pure Python (test oracle).

    ``entries`` is a ``{int key: float value}`` dict; lanes apply in
    announcement order.  With ``capacity``, an insert of an ABSENT key is
    rejected ``R_FULL`` iff its hash bucket already holds ``bslots`` live
    keys.  CAS decode runs in float32, bit-identical to the device's.
    Returns (new_entries, responses, kinds).
    """
    n = len(ops)
    responses = [0.0] * n
    kinds = [R_NONE] * n
    m = dict(entries)
    if capacity is not None:
        bslots, n_buckets = map_geometry(int(capacity))
        bucket_of = {k: int(map_bucket_host([k], n_buckets)[0]) for k in m}
    for i in range(n):
        op = int(ops[i])
        key = int(keys[i])
        par = float(np.float32(params[i]))
        if op == OP_MAP_INSERT:
            if key not in m and capacity is not None:
                b = int(map_bucket_host([key], n_buckets)[0])
                if sum(1 for v in bucket_of.values() if v == b) >= bslots:
                    kinds[i] = R_FULL
                    continue
                bucket_of[key] = b
            m[key] = par
            kinds[i] = R_ACK
        elif op == OP_MAP_LOOKUP:
            if key in m:
                responses[i] = m[key]
                kinds[i] = R_VALUE
            else:
                kinds[i] = R_EMPTY
        elif op == OP_MAP_DELETE:
            if key in m:
                responses[i] = m.pop(key)
                kinds[i] = R_VALUE
                if capacity is not None:
                    bucket_of.pop(key, None)
            else:
                kinds[i] = R_EMPTY
        elif op == OP_MAP_CAS:
            expected = float(np.floor(np.float32(par) / np.float32(CAS_DOM)))
            new = float(np.float32(par) - np.float32(expected) * np.float32(CAS_DOM))
            if key not in m:
                kinds[i] = R_EMPTY
            elif m[key] == expected:
                responses[i] = m[key]
                m[key] = new
                kinds[i] = R_VALUE
            else:
                responses[i] = m[key]
                kinds[i] = R_CAS_FAIL
    return m, responses, kinds


# ================================================================== registry
@dataclasses.dataclass(frozen=True)
class StructSpec:
    """One of the paper's structures, as seen by multi-object runtimes.

    ``init``/``combine``/``reference`` are the entry points above;
    ``n_opcodes`` bounds the valid op-code range [0, n_opcodes);
    ``op_lanes`` maps each op code to its announcement lane; keyed kinds
    (the map) take an extra ``keys`` argument in ``combine``/``reference``.
    """

    kind: str
    state_cls: type
    init: Callable[..., Any]
    combine: Callable[..., Any]
    reference: Callable[..., Any]
    n_opcodes: int
    op_lanes: Tuple[int, ...] = ()
    keyed: bool = False

    @property
    def lane_splittable(self) -> bool:
        """Whether the kind has both a head and a tail side (queue, deque)."""
        return LANE_HEAD in self.op_lanes and LANE_TAIL in self.op_lanes


STRUCTS: Dict[str, StructSpec] = {
    "stack": StructSpec(
        "stack", StackState, init_stack, combine, sequential_reference, 3,
        op_lanes=(LANE_NONE, LANE_NONE, LANE_NONE),
    ),
    "queue": StructSpec(
        "queue", QueueState, init_queue, combine_queue,
        sequential_reference_queue, 3,
        op_lanes=(LANE_NONE, LANE_TAIL, LANE_HEAD),
    ),
    "deque": StructSpec(
        "deque", DequeState, init_deque, combine_deque,
        sequential_reference_deque, 5,
        op_lanes=(LANE_NONE, LANE_HEAD, LANE_HEAD, LANE_TAIL, LANE_TAIL),
    ),
    "map": StructSpec(
        "map", MapState, init_map, combine_map, sequential_reference_map, 5,
        op_lanes=(LANE_NONE,) * 5,
        keyed=True,
    ),
}


def lane_of_ops(kind: str, ops: torch.Tensor) -> torch.Tensor:
    """Per-op announcement lane of a batch targeting ``kind`` shards."""
    table = torch.tensor(STRUCTS[kind].op_lanes, dtype=torch.int32, device=ops.device)
    return table[ops.long().clamp(0, table.shape[0] - 1)]


def lane_of_ops_host(kind: str, ops) -> np.ndarray:
    """NumPy twin of :func:`lane_of_ops`."""
    table = np.asarray(STRUCTS[kind].op_lanes, np.int32)
    o = np.asarray(ops, np.int32)
    return table[np.clip(o, 0, table.shape[0] - 1)]


def struct_kind(state) -> str:
    """Structure kind of a (possibly shard-stacked) state."""
    for kind, spec in STRUCTS.items():
        if isinstance(state, spec.state_cls):
            return kind
    raise TypeError(f"not a DFC structure state: {type(state)!r}")


# stable integer codes for structure kinds, in sorted-kind order
KIND_CODES: Dict[str, int] = {kind: i for i, kind in enumerate(sorted(STRUCTS))}


def state_from_contents(kind: str, contents, capacity: int, epoch: int,
                        device="cuda"):
    """Build a committed single-object state holding exactly ``contents``
    (bottom-to-top for the stack, left-to-right for the rings, ``(key,
    value)`` pairs for the map) at the given even ``epoch``."""
    spec = STRUCTS[kind]
    n = len(contents)
    if n > capacity:
        raise ValueError(f"{n} values exceed capacity {capacity}")
    state = spec.init(capacity, device=device)
    active = (epoch // 2) % 2
    ep = torch.tensor(epoch, dtype=torch.int32, device=device)
    if kind == "map":
        bslots, n_buckets = map_geometry(capacity)
        mk = np.zeros((capacity,), np.int32)
        mv = np.zeros((capacity,), np.float32)
        mo = np.zeros((capacity,), np.int32)
        for key, val in contents:
            base = int(map_bucket_host([int(key)], n_buckets)[0]) * bslots
            for j in range(bslots):
                if not mo[base + j]:
                    mk[base + j] = int(key)
                    mv[base + j] = val
                    mo[base + j] = 1
                    break
            else:
                raise ValueError(
                    f"map bucket {base // bslots} overflows rebuilding "
                    f"{n} entries at capacity {capacity}"
                )
        count = state.count.clone()
        count[active] = n
        return MapState(
            keys=torch.from_numpy(mk).to(device),
            values=torch.from_numpy(mv).to(device),
            occupied=torch.from_numpy(mo).to(device),
            count=count,
            epoch=ep,
        )
    values = state.values.clone()
    if n:
        values[:n] = torch.as_tensor(np.asarray(contents, np.float32), device=device)
    if kind == "stack":
        size = state.size.clone()
        size[active] = n
        return StackState(values=values, size=size, epoch=ep)
    ends = state.ends.clone()
    ends[active] = torch.tensor([0, n], dtype=torch.int32, device=device)
    return spec.state_cls(values=values, ends=ends, epoch=ep)


# ============================================================ state transfer
def state_from_numpy(kind: str, arrays, device="cuda"):
    """A port state from numpy leaves in field order (the JAX state's
    ``tree_flatten`` order), same dtypes and shapes; ``epoch`` is a 0-d
    int32 (or ``[S]`` for a shard-stacked state)."""
    cls = STRUCTS[kind].state_cls
    fields = dataclasses.fields(cls)
    if len(arrays) != len(fields):
        raise ValueError(f"{kind} state has {len(fields)} leaves, got {len(arrays)}")
    return cls(*[
        torch.from_numpy(np.array(a, copy=True)).to(device) for a in arrays
    ])


def state_to_numpy(state) -> List[np.ndarray]:
    """Inverse of :func:`state_from_numpy`: the leaves as numpy arrays."""
    return [leaf.detach().cpu().numpy() for leaf in state.leaves()]


# ============================================================ announce ring
@dataclasses.dataclass
class AnnounceRing(_State):
    """Device-side announcement queue: a preallocated ring of (key, op,
    param, lane) slots that announced batches land in, so combining phases
    read device tensors instead of rebuilding them from the durable
    records.  ``tail`` is the absolute producer counter; slot = counter %
    slots.  Which spans are still live is tracked on the host."""

    keys: torch.Tensor  # i32[slots]
    ops: torch.Tensor  # i32[slots]
    params: torch.Tensor  # f32[slots]
    lanes: torch.Tensor  # i32[slots]
    tail: torch.Tensor  # i32[] — absolute producer counter


def init_announce_ring(slots: int, device="cuda") -> AnnounceRing:
    """An empty ring of ``slots`` lanes; ``slots`` must be a power of two so
    that the wrapping int32 ``tail`` and the host's unbounded mirror agree
    on slot indices forever."""
    if slots <= 0 or (slots & (slots - 1)) != 0:
        raise ValueError(f"ring slots must be a power of two, got {slots}")
    return AnnounceRing(
        keys=torch.zeros((slots,), dtype=torch.int32, device=device),
        ops=torch.full((slots,), OP_NONE, dtype=torch.int32, device=device),
        params=torch.zeros((slots,), dtype=torch.float32, device=device),
        lanes=torch.full((slots,), LANE_NONE, dtype=torch.int32, device=device),
        tail=torch.zeros((), dtype=torch.int32, device=device),
    )


def ring_announce(ring: AnnounceRing, keys, ops, params, lanes=None) -> AnnounceRing:
    """Land one announced batch at the ring tail (one scatter per field).
    The caller guarantees the span does not overlap a live span.  ``lanes``
    stages each op's announcement lane beside it (``LANE_NONE`` for every
    op when omitted)."""
    n = ops.shape[0]
    slots = ring.keys.shape[0]
    dev = ring.keys.device
    pos = torch.remainder(ring.tail.long() + torch.arange(n, device=dev), slots)
    lane_col = (torch.full((n,), LANE_NONE, dtype=torch.int32, device=dev)
                if lanes is None else torch.as_tensor(lanes).to(dev, torch.int32))

    def land(col, vals):
        out = col.clone()
        out[pos] = vals
        return out

    return AnnounceRing(
        keys=land(ring.keys, to_int32(keys).to(dev)),
        ops=land(ring.ops, ops.to(dev, torch.int32)),
        params=land(ring.params, params.to(dev, torch.float32)),
        lanes=land(ring.lanes, lane_col),
        tail=ring.tail + n,
    )


def ring_has_room(slots: int, tail: int, oldest_live: int, n: int) -> bool:
    """Host-side admission check for a span of ``n`` lanes landing at
    absolute position ``tail``: it must not wrap onto the oldest span still
    awaiting its combining phase (``oldest_live``; ``tail`` when none)."""
    return n <= slots and (tail + n) - oldest_live <= slots


def ring_drain(ring: AnnounceRing, start: int, n: int, lane=None):
    """Read span [start, start+n) of the ring as device tensors ``(keys,
    ops, params)``; ``start`` is the absolute counter it was announced at.
    With ``lane``, ops staged on another lane read as ``OP_NONE`` (positions
    kept, so per-op bookkeeping lines up with the unfiltered span)."""
    idx = torch.remainder(
        start + torch.arange(n, device=ring.keys.device), ring.keys.shape[0]
    )
    ops = ring.ops[idx]
    if lane is not None:
        ops = torch.where(ring.lanes[idx] == int(lane), ops, OP_NONE)
    return ring.keys[idx], ops, ring.params[idx]


def ring_announce_phases(ring: AnnounceRing, keys, ops, params, lanes=None
                         ) -> AnnounceRing:
    """Land a whole phase schedule -- ``[K, pad]`` per-phase batches padded
    with ``OP_NONE`` lanes -- at the ring tail in one scatter; the K phases
    occupy the contiguous span ``[tail, tail + K*pad)``."""
    return ring_announce(ring, keys.reshape(-1), ops.reshape(-1), params.reshape(-1),
                         None if lanes is None else torch.as_tensor(lanes).reshape(-1))


def ring_drain_phases(ring: AnnounceRing, start: int, k: int, pad: int, lane=None):
    """Read ``k`` phases of ``pad`` lanes announced at absolute position
    ``start`` back as ``[K, pad]`` device tensors (one gather for the whole
    schedule); ``lane`` filters as in :func:`ring_drain`."""
    keys, ops, params = ring_drain(ring, start, k * pad, lane=lane)
    return keys.reshape(k, pad), ops.reshape(k, pad), params.reshape(k, pad)


# ============================================================ phase intents
@dataclasses.dataclass
class PhaseIntents:
    """Persist-intent log of a fused K-phase combine: everything the host
    needs to issue each phase's pwb/pfence batch later, in serial order.

    All fields are ``[K, S]``: ``epoch`` (per-shard epoch after phase k, the
    commit target of every op phase k routed there), ``touched`` (shard s
    received ops in phase k; untouched shards keep state and epoch),
    ``phases_cum`` and ``ops_cum`` (combining phases and ops absorbed by
    shard s up to and including phase k, counted from the dispatch's start;
    the runtime adds its durable ``meta`` baseline).
    """

    epoch: torch.Tensor  # i32[K, S]
    touched: torch.Tensor  # bool[K, S]
    phases_cum: torch.Tensor  # i32[K, S]
    ops_cum: torch.Tensor  # i32[K, S]


# ============================================================ shard stacking
def replicate_state(state, n_shards: int):
    """Stack ``n_shards`` copies of a single-object state along a new
    leading shard axis (materialized, so shards can diverge)."""
    return map_state(
        lambda leaf: leaf.unsqueeze(0).expand((n_shards,) + leaf.shape).clone(),
        state,
    )


def init_sharded(kind: str, n_shards: int, capacity: int, dtype=torch.float32,
                 device="cuda"):
    """``n_shards`` homogeneous DFC objects as one shard-stacked state;
    each shard keeps its own epoch."""
    return replicate_state(
        STRUCTS[kind].init(capacity, dtype, device=device), n_shards
    )


def shard_slice(state, s: int):
    """Shard ``s`` of a stacked state as a single-object state."""
    return map_state(lambda leaf: leaf[s], state)


def stack_shards(shard_states):
    """Inverse of ``shard_slice`` over all shards."""
    return map_state(lambda *leaves: torch.stack(leaves), *shard_states)
