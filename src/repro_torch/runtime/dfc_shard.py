"""Sharded multi-object DFC runtime on PyTorch: one announcement fabric,
many objects.

Counterpart of the JAX package's ``runtime/dfc_shard.py``, serial durable
path.  ``n_shards`` DFC structures -- stacks, queues, deques and maps, mixed
freely -- live behind ONE announcement fabric.  A key->shard router buckets
each announced batch into per-shard lanes, and the combine runs every
shard's phase grouped BY KIND: one kernel launch per kind present (one
thread block per shard), see ``kernels/dfc_reduce/ops.py``.

Paper mechanisms (Algorithm/line numbers of arXiv:2012.12868):

  * announce (Alg. 1 lines 2-12): per-thread double-buffered announcement
    records (``ann{0,1}`` + a 2-bit ``valid`` selector, MSB published last),
    plus a copy in the device ring ``AnnounceRing``,
  * combine + single pfence (Alg. 2, line 80): one durable phase persists
    every touched shard's new state and every combined response, then
    pfences ONCE,
  * two-increment epoch commit (Alg. 1 lines 81-83), per shard: persist
    cEpoch=v+1, publish v+2 unsynced; recovery rounds odd up to even,
  * detectability: recovery reports, per thread and per op, whether the op
    took effect and with which response; ``replay_pending`` re-announces
    exactly the ops that did not.

Durable layout (``SimFS``, pwb = write, pfence = fsync), byte for byte the
reference's, so either package recovers a root the other wrote::

  tAnn/thread_{t}/ann{0,1}.json   double-buffered announcements + valid
  shard_{s}/slot{0,1}/...         alternating state slots, picked by parity
  shard_{s}/cEpoch                per-shard two-increment commit
  shard_{s}/lane{H,T}{0,1}/...    per-side lane slots (``split_lanes``)
  routing/slot{0,1}.json          alternating routing records
  routing/rEpoch                  routing-epoch two-increment commit
  reshard/intent.json             reshard transaction record
  reshard/ckpt/...                donor snapshots (DFCCheckpointManager)

The volatile ``step``, the serial durable path, the depth-D pipelined
durable path (``depth``, ``chain``: up to D-1 dispatched chains kept in
flight, retired in commit order), the fused K-phase ``phase_loop``, per-side
lanes (``split_lanes``: each queue and deque shard commits its head and
tail sides through their own records and epochs) and resharding
(``split_shard``, ``merge_shards``: a mini-transaction whose commit point is
the routing epoch) are ported, with the flight recorder's hooks (``obs``, a
``FabricObserver``): the reference's events at the same protocol steps
(topology, announce, dispatch, retire, epoch commit, drain, reshard,
recovery begin/end and one verdict per thread) and its per-shard gauges.

A reshard runs: (1) drain the ready announcements and the pipeline, (2)
snapshot the donor through ``DFCCheckpointManager.combine_structure`` under
``reshard/ckpt``, (3) persist the intent, pfence, (4) pwb the post-reshard
shard states (merge only) and the new routing record, ONE pfence, (5)
commit ``rEpoch`` with the two-increment protocol -- the commit point --
(6) roll the touched shards' epochs forward (merge only) and drop the
intent.  Recovery rolls an intent forward when ``rEpoch`` reached its
target and back otherwise.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import io
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.dfc_checkpoint import BOT, DFCCheckpointManager, SimFS
from repro_torch.core.torch_dfc import (
    KIND_CODES,
    LANE_HEAD,
    LANE_NONE,
    LANE_TAIL,
    OP_NONE,
    R_NONE,
    STRUCTS,
    PhaseIntents,
    _mul_u32,
    _as_u32,
    init_announce_ring,
    init_sharded,
    lane_of_ops_host,
    map_state,
    ring_announce,
    ring_announce_phases,
    ring_drain,
    ring_drain_phases,
    ring_has_room,
    shard_slice,
    stack_shards,
    state_from_contents,
    to_int32,
)
from repro_torch.kernels.dfc_reduce.ops import (
    _one_sharded_combine,
    dfc_hetero_combine_step,
    dfc_hetero_multi_combine_step,
    dfc_hetero_multi_phase_step,
    select_touched,
)
from repro_torch.obs import (
    EV_ANNOUNCE,
    EV_DISPATCH,
    EV_DRAIN,
    EV_EPOCH,
    EV_RECOVER,
    EV_RESHARD,
    EV_RETIRE,
    EV_TOPOLOGY,
    EV_VERDICT,
    NULL_OBS,
)

# runtime-level response kind: op rejected because its shard's announcement
# lanes were full this phase — never applied, safe to re-announce.
R_OVERFLOW = 4

_HASH_MULT = 2654435761  # Knuth multiplicative hashing constant

# Per-side lanes: with ``split_lanes=True`` every queue and deque shard
# commits through TWO announcement lanes -- a HEAD lane (the consuming side:
# OP_DEQ / OP_POPL, plus OP_PUSHL, which lives on the deque's left end) and a
# TAIL lane (the producing side: OP_ENQ / OP_PUSHR / OP_POPR) -- each with its
# own durable record, its own epoch and its own one-pfence commit:
#
#   shard_{s}/laneH{0,1}/rec.json [+ values.npy]   head-lane slots
#   shard_{s}/laneT{0,1}/rec.json + values.npy     tail-lane slots
#   shard_{s}/cEpoch = "[eH, eT]"                  composite epoch pair
#
# Each lane's slot parity follows its own epoch; the pair lives in one file
# (a SimFS write is all or nothing), which the handoff commit relies on: a
# phase that mixes both sides, or a head-side phase that leaves the
# structure drained, commits both lanes in one two-increment step.  The
# queue's head lane never writes values (pops only move the head counter);
# the deque's left side pushes, so both deque lanes carry values, and
# recovery takes them from the lane record with the larger ``phases``.
_LANE_WRITES_VALUES = {"queue": (False, True), "deque": (True, True)}
_LANE_TAGS = ("H", "T")  # indexed by LANE_HEAD / LANE_TAIL


class StaleTokenError(LookupError):
    """``read_responses(thread, token)`` named a batch whose durable response
    record no longer exists: the double-buffered announcement slots retain
    only a thread's last two batches, and ``token`` predates both."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card is
    an error, never a quiet move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return dev


def _to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ===================================================================== router
def shard_of_keys(keys, n_shards: int) -> torch.Tensor:
    """bucket(key): multiplicative hash, identical on host and device, over
    keys cut to 32 bits (as the reference sees them)."""
    h = _mul_u32(_as_u32(keys), _HASH_MULT)
    h = h ^ (h >> 16)
    return (h % n_shards).to(torch.int32)


def shard_of_keys_host(keys, n_shards: int) -> np.ndarray:
    """NumPy twin of ``shard_of_keys`` for oracles and drivers."""
    k = np.asarray(keys).astype(np.uint32)
    h = k * np.uint32(_HASH_MULT)
    h = h ^ (h >> np.uint32(16))
    return (h % np.uint32(n_shards)).astype(np.int32)


def route_keys_host(keys, n_shards: int, table=None) -> np.ndarray:
    """Host routing: bucket hash + optional table lookup."""
    if table is None:
        return shard_of_keys_host(keys, n_shards)
    table = np.asarray(table)
    return table[shard_of_keys_host(keys, len(table))].astype(np.int32)


def zipf_keys(rng, n: int, universe: int, skew: float) -> np.ndarray:
    """Zipfian key draw over a finite universe (skew=0 -> uniform) from an
    explicit ``numpy.random.Generator``."""
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    p = ranks ** (-skew) if skew > 0 else np.ones(universe)
    p /= p.sum()
    return rng.choice(universe, size=n, p=p)


def weighted_cycle(weights) -> List[int]:
    """The deterministic weighted-round-robin cycle over priority classes.

    Class ``c`` (higher = more urgent) appears ``weights[c]`` times; classes
    are laid out highest-first with each class's slots CONTIGUOUS, so within
    one cycle the urgent classes drain their whole credit burst before the
    next class starts, and the lowest class's credits sit at the cycle's
    tail.  The contiguity is what makes the starvation bound of
    :func:`weighted_dequeue_plan` tight: between two credits of class ``c``
    there are exactly ``sum(weights) - weights[c]`` foreign credits.
    """
    ws = [int(w) for w in weights]
    if not ws or any(w < 1 for w in ws):
        raise ValueError(f"class weights must all be >= 1, got {list(weights)}")
    cyc: List[int] = []
    for c in range(len(ws) - 1, -1, -1):
        cyc.extend([c] * ws[c])
    return cyc


def weighted_dequeue_plan(
    backlogs, weights, n: int, cursor: int = 0
) -> Tuple[List[int], int]:
    """Plan ``n`` dequeues across per-class shards by weighted round-robin.

    ``backlogs[c]`` is class ``c``'s committed shard backlog, ``weights[c]``
    its per-cycle dequeue credit, ``cursor`` the persistent position in the
    weighted cycle (thread it through successive calls).  Returns
    ``(plan, new_cursor)`` where ``plan`` lists the class shard to dequeue
    for each of up to ``n`` slots.  The walk is work-conserving: a credit
    landing on an empty class is skipped, so the plan emits
    ``min(n, sum(backlogs))`` dequeues.

    Starvation bound: between two consecutive dequeues of a class ``c`` that
    stays backlogged, at most ``sum(weights) - weights[c]`` other dequeues
    are emitted, across plan-call boundaries, for any backlog mix.
    """
    left = [int(b) for b in backlogs]
    cyc = weighted_cycle(weights)
    if len(left) != len(set(cyc)):
        raise ValueError(
            f"backlogs ({len(left)} classes) must parallel weights "
            f"({len(set(cyc))} classes)"
        )
    w_total = len(cyc)
    cursor = int(cursor) % w_total
    plan: List[int] = []
    while len(plan) < n and any(v > 0 for v in left):
        c = cyc[cursor]
        cursor = (cursor + 1) % w_total
        if left[c] > 0:
            plan.append(c)
            left[c] -= 1
    return plan, cursor


def route_batch(keys, ops, params, *, n_shards: int, lanes: int, table=None):
    """Bucket a flat announced batch into per-shard op lists, on the device
    of ``ops``.

    Returns ``(shard_ops i32[S, L], shard_params f32[S, L], shard i32[B],
    lane i32[B], ok bool[B], overflow bool[B], shard_keys i32[S, L])``.
    An op's lane is its batch-order rank among the ops routed to its shard
    (stable), so per-shard op lists keep announcement order.  Ops ranked
    past ``lanes`` overflow and touch no shard; ``OP_NONE`` lanes are never
    routed.  ``table`` (``i32[n_buckets]``, bucket -> shard) routes through
    a custom table; ``None`` is the identity.
    """
    dev = ops.device
    keys32 = to_int32(keys).to(dev)
    ops32 = ops.to(torch.int32)
    b = ops32.shape[0]
    if table is None:
        shard = shard_of_keys(keys32, n_shards)
    else:
        t = table.to(dev)
        shard = t[shard_of_keys(keys32, t.shape[0]).long()].to(torch.int32)
    active = ops32 != OP_NONE
    s_eff = torch.where(active, shard.long(), n_shards)  # n_shards: nowhere

    # stable rank of op j within its shard: exclusive prefix sum per segment
    onehot = s_eff[None, :] == torch.arange(n_shards, device=dev)[:, None]
    rank_mat = onehot.int().cumsum(1, dtype=torch.int32) - 1  # [S, B]
    lane = rank_mat[s_eff.clamp(0, n_shards - 1), torch.arange(b, device=dev)]

    ok = active & (lane < lanes)
    overflow = active & (lane >= lanes)

    # dest is injective over ok lanes; the rest land in a sink slot
    sink = n_shards * lanes
    dest = torch.where(ok, s_eff * lanes + lane.long(), sink)
    flat_ops = torch.full((sink + 1,), OP_NONE, dtype=torch.int32, device=dev)
    flat_params = torch.zeros((sink + 1,), dtype=torch.float32, device=dev)
    flat_keys = torch.zeros((sink + 1,), dtype=torch.int32, device=dev)
    flat_ops[dest] = ops32
    flat_params[dest] = params.to(dev, torch.float32)
    flat_keys[dest] = keys32
    return (
        flat_ops[:sink].reshape(n_shards, lanes),
        flat_params[:sink].reshape(n_shards, lanes),
        shard,
        lane,
        ok,
        overflow,
        flat_keys[:sink].reshape(n_shards, lanes),
    )


# ================================================================ fused steps
def _gather_flat(ok, overflow, shard, lane, resp_mat, kind_mat, n_shards, lanes):
    """Responses back in flat batch order (overflow -> ``R_OVERFLOW``)."""
    s = shard.long().clamp(0, n_shards - 1)
    ln = lane.long().clamp(0, lanes - 1)
    responses = torch.where(ok, resp_mat[..., s, ln], 0.0)
    out_kinds = torch.where(ok, kind_mat[..., s, ln], R_NONE)
    out_kinds = torch.where(overflow, R_OVERFLOW, out_kinds).to(torch.int32)
    return responses, out_kinds


def _bump_meta(meta, touched, n_ops):
    new_meta = dict(meta)  # carry extra columns (e.g. "kind") through
    new_meta["phases"] = (meta["phases"] + touched.int()).to(torch.int32)
    new_meta["ops_combined"] = (meta["ops_combined"] + n_ops).to(torch.int32)
    return new_meta


def sharded_step(state, keys, ops, params, meta, *, kind: str, n_shards: int,
                 lanes: int, backend: str = "kernel"):
    """One end-to-end phase over a HOMOGENEOUS fabric.  ``meta`` is
    ``{"phases": i32[S], "ops_combined": i32[S]}``; untouched shards keep
    their state and epoch.  Returns ``(new_state, new_meta, responses
    f32[B], kinds i32[B])``."""
    shard_ops, shard_params, shard, lane, ok, overflow, shard_keys = route_batch(
        keys, ops, params, n_shards=n_shards, lanes=lanes
    )
    combined, s_resp, s_kinds = _one_sharded_combine(
        kind, backend, state, shard_ops, shard_params, keys=shard_keys
    )
    live = shard_ops != OP_NONE
    touched = live.any(1)
    new_state = select_touched(touched, combined, state)
    new_meta = _bump_meta(meta, touched, live.sum(1))
    responses, out_kinds = _gather_flat(
        ok, overflow, shard, lane, s_resp, s_kinds, n_shards, lanes
    )
    return new_state, new_meta, responses, out_kinds


@functools.lru_cache(maxsize=None)
def _group_ids(kinds: Tuple[str, ...]) -> Dict[str, Tuple[int, ...]]:
    """Global shard ids per kind, in ascending shard order."""
    out: Dict[str, List[int]] = {}
    for s, k in enumerate(kinds):
        out.setdefault(k, []).append(s)
    return {k: tuple(v) for k, v in out.items()}


def _group_rows(kinds, device) -> Dict[str, torch.Tensor]:
    return {
        k: torch.tensor(ids, dtype=torch.long, device=device)
        for k, ids in _group_ids(tuple(kinds)).items()
    }


def hetero_step(groups, table, keys, ops, params, meta, *,
                kinds: Tuple[str, ...], lanes: int, backend: str = "kernel"):
    """One end-to-end phase over a HETEROGENEOUS fabric: route, one combine
    per kind group present, keep untouched shards, gather responses.  Op
    codes are interpreted by the TARGET shard's structure.

    Returns ``(new_groups, new_meta, responses f32[B], out_kinds i32[B])``.
    """
    n_shards = len(kinds)
    dev = ops.device
    shard_ops, shard_params, shard, lane, ok, overflow, shard_keys = route_batch(
        keys, ops, params, n_shards=n_shards, lanes=lanes, table=table
    )
    rows = _group_rows(kinds, dev)
    group_ops = {k: shard_ops[r] for k, r in rows.items()}
    combined = dfc_hetero_combine_step(
        groups, group_ops, {k: shard_params[r] for k, r in rows.items()},
        backend=backend, group_keys={k: shard_keys[r] for k, r in rows.items()},
    )

    resp_mat = torch.zeros((n_shards, lanes), dtype=torch.float32, device=dev)
    kind_mat = torch.full((n_shards, lanes), R_NONE, dtype=torch.int32, device=dev)
    new_groups = {}
    for k in sorted(rows):
        new_state, s_resp, s_kinds = combined[k]
        g_touched = (group_ops[k] != OP_NONE).any(1)
        new_groups[k] = select_touched(g_touched, new_state, groups[k])
        resp_mat[rows[k]] = s_resp
        kind_mat[rows[k]] = s_kinds

    live = shard_ops != OP_NONE
    new_meta = _bump_meta(meta, live.any(1), live.sum(1))
    responses, out_kinds = _gather_flat(
        ok, overflow, shard, lane, resp_mat, kind_mat, n_shards, lanes
    )
    return new_groups, new_meta, responses, out_kinds


def hetero_multi_step(groups, table, keys, ops, params, meta, *,
                      kinds: Tuple[str, ...], lanes: int, backend: str = "kernel"):
    """Route + combine a CHAIN of flat batches over a heterogeneous fabric.

    ``keys`` / ``ops`` / ``params`` are ``[B, L]`` (batches padded with
    ``OP_NONE``).  Each batch is routed independently and batch b+1 combines
    on top of batch b's state, exactly as B ``hetero_step`` calls would.

    Returns ``(new_groups, new_meta, responses [B, L], out_kinds [B, L],
    states, epochs_before i32[S], epochs i32[B, S], phases_cum i32[B, S],
    ops_cum i32[B, S])``: ``states[kind]`` carries the per-batch states
    (leading B axis), ``epochs[b]`` the per-shard epochs after batch b (each
    op's durable commit target).
    """
    n_batches = ops.shape[0]
    n_shards = len(kinds)
    dev = ops.device
    routed = [
        route_batch(keys[i], ops[i], params[i], n_shards=n_shards, lanes=lanes,
                    table=table)
        for i in range(n_batches)
    ]
    shard_ops = torch.stack([r[0] for r in routed])  # [B, S, L]
    shard_params = torch.stack([r[1] for r in routed])
    shard_keys = torch.stack([r[6] for r in routed])

    rows = _group_rows(kinds, dev)
    multi = dfc_hetero_multi_combine_step(
        groups,
        {k: shard_ops[:, r] for k, r in rows.items()},
        {k: shard_params[:, r] for k, r in rows.items()},
        backend=backend,
        group_keys={k: shard_keys[:, r] for k, r in rows.items()},
    )

    resp_mat = torch.zeros((n_batches, n_shards, lanes), dtype=torch.float32,
                           device=dev)
    kind_mat = torch.full((n_batches, n_shards, lanes), R_NONE, dtype=torch.int32,
                          device=dev)
    epochs = torch.zeros((n_batches, n_shards), dtype=torch.int32, device=dev)
    epochs_before = torch.zeros((n_shards,), dtype=torch.int32, device=dev)
    new_groups, states = {}, {}
    for k in sorted(rows):
        r = rows[k]
        st, s_resp, s_kinds = multi[k]
        states[k] = st
        new_groups[k] = map_state(lambda leaf: leaf[-1], st)
        resp_mat[:, r] = s_resp
        kind_mat[:, r] = s_kinds
        epochs[:, r] = st.epoch
        epochs_before[r] = groups[k].epoch

    live = shard_ops != OP_NONE
    touched = live.any(2).int()  # [B, S]
    per_batch_ops = live.sum(2)
    new_meta = _bump_meta(meta, touched.sum(0), per_batch_ops.sum(0))
    phases_cum = (meta["phases"][None] + touched.cumsum(0)).to(torch.int32)
    ops_cum = (meta["ops_combined"][None] + per_batch_ops.cumsum(0)).to(torch.int32)

    responses, out_kinds = [], []
    for i, (_, _, shard, lane, ok, overflow, _) in enumerate(routed):
        rsp, knd = _gather_flat(ok, overflow, shard, lane, resp_mat[i], kind_mat[i],
                                n_shards, lanes)
        responses.append(rsp)
        out_kinds.append(knd)
    return (
        new_groups, new_meta, torch.stack(responses), torch.stack(out_kinds),
        states, epochs_before, epochs, phases_cum, ops_cum,
    )


def hetero_phase_loop_step(groups, table, keys, ops, params, meta, *,
                           kinds: Tuple[str, ...], lanes: int, backend: str = "kernel",
                           unroll: int = 1, phase_axis: str = "scan",
                           donate: Optional[bool] = None):
    """Route + combine K PHASES over a heterogeneous fabric, collecting each
    phase's persist intents.

    ``keys`` / ``ops`` / ``params`` are ``[K, L]``: K per-phase flat batches
    padded with ``OP_NONE``.  Each phase is routed on its own, and every kind
    group runs its K phases through ``dfc_hetero_multi_phase_step`` (one
    K-phase kernel launch per kind with ``phase_axis="grid"``, one one-phase
    launch per phase and kind with ``"scan"``): phase k+1 combines on top of
    phase k, exactly as K ``hetero_step`` calls would.  ``unroll`` and
    ``donate`` are the reference's scan-unroll and buffer-donation knobs;
    PyTorch runs eagerly and frees what it no longer holds, so they change
    nothing here.

    Returns ``(new_groups, new_meta, responses [K, L], out_kinds [K, L],
    states, epochs_before i32[S], intents)``: ``states[kind]`` carries the
    per-phase states (leading K axis) and ``intents`` is the
    :class:`PhaseIntents` log with its cumulative counters re-based on
    ``meta``.
    """
    n_shards = len(kinds)
    k_phases = ops.shape[0]
    dev = ops.device
    routed = [
        route_batch(keys[j], ops[j], params[j], n_shards=n_shards, lanes=lanes,
                    table=table)
        for j in range(k_phases)
    ]
    shard_ops = torch.stack([r[0] for r in routed])  # [K, S, L]
    shard_params = torch.stack([r[1] for r in routed])
    shard_keys = torch.stack([r[6] for r in routed])
    rows = _group_rows(kinds, dev)
    multi = dfc_hetero_multi_phase_step(
        groups,
        {k: shard_ops[:, r] for k, r in rows.items()},
        {k: shard_params[:, r] for k, r in rows.items()},
        backend=backend, unroll=unroll, phase_axis=phase_axis,
        group_keys={k: shard_keys[:, r] for k, r in rows.items()},
    )

    resp_mat = torch.zeros((k_phases, n_shards, lanes), dtype=torch.float32, device=dev)
    kind_mat = torch.full((k_phases, n_shards, lanes), R_NONE, dtype=torch.int32,
                          device=dev)
    epochs = torch.zeros((k_phases, n_shards), dtype=torch.int32, device=dev)
    epochs_before = torch.zeros((n_shards,), dtype=torch.int32, device=dev)
    touched = torch.zeros((k_phases, n_shards), dtype=torch.bool, device=dev)
    phases_cum = torch.zeros((k_phases, n_shards), dtype=torch.int32, device=dev)
    ops_cum = torch.zeros((k_phases, n_shards), dtype=torch.int32, device=dev)
    new_groups, states = {}, {}
    for k in sorted(rows):
        r = rows[k]
        st, s_resp, s_kinds, intents = multi[k]
        states[k] = st
        new_groups[k] = map_state(lambda leaf: leaf[-1], st)
        resp_mat[:, r] = s_resp
        kind_mat[:, r] = s_kinds
        epochs[:, r] = intents.epoch
        epochs_before[r] = groups[k].epoch
        touched[:, r] = intents.touched
        # re-base the dispatch-relative counters on the durable meta: row k
        # is then exactly what phase k's slot persist records
        phases_cum[:, r] = meta["phases"][r][None] + intents.phases_cum
        ops_cum[:, r] = meta["ops_combined"][r][None] + intents.ops_cum

    new_meta = dict(meta)
    new_meta["phases"] = phases_cum[-1]
    new_meta["ops_combined"] = ops_cum[-1]
    responses, out_kinds = [], []
    for j, (_, _, shard, lane, ok, overflow, _) in enumerate(routed):
        rsp, knd = _gather_flat(ok, overflow, shard, lane, resp_mat[j], kind_mat[j],
                                n_shards, lanes)
        responses.append(rsp)
        out_kinds.append(knd)
    intents_out = PhaseIntents(epoch=epochs, touched=touched, phases_cum=phases_cum,
                               ops_cum=ops_cum)
    return (
        new_groups, new_meta, torch.stack(responses), torch.stack(out_kinds),
        states, epochs_before, intents_out,
    )


# ============================================================== host oracle
def sequential_hetero_reference(kinds, shard_lists, keys, ops, params, lanes,
                                table=None, capacity=None):
    """Pure-Python witness of one heterogeneous sharded phase (test oracle).

    ``kinds[s]`` names shard ``s``'s structure; ``shard_lists[s]`` is its
    contents, mutated in place (a dict for keyed kinds).  Returns
    (responses, kinds) in flat batch order, overflow ops as ``R_OVERFLOW``.
    """
    n_shards = len(shard_lists)
    shard = route_keys_host(keys, n_shards, table)
    b = len(ops)
    responses = [0.0] * b
    out_kinds = [R_NONE] * b
    buckets: Dict[int, List[int]] = {}
    for j in range(b):
        if ops[j] == OP_NONE:
            continue
        s = int(shard[j])
        rank = len(buckets.setdefault(s, []))
        if rank >= lanes:
            out_kinds[j] = R_OVERFLOW
            continue
        buckets[s].append(j)
    for s, idxs in sorted(buckets.items()):
        s_ops = [ops[j] for j in idxs]
        s_par = [params[j] for j in idxs]
        spec = STRUCTS[kinds[s]]
        if spec.keyed:
            s_keys = [keys[j] for j in idxs]
            shard_lists[s], s_resp, s_kinds = spec.reference(
                shard_lists[s], s_keys, s_ops, s_par, capacity=capacity
            )
        else:
            shard_lists[s], s_resp, s_kinds = spec.reference(
                shard_lists[s], s_ops, s_par
            )
        for r, (v, k) in zip(idxs, zip(s_resp, s_kinds)):
            responses[r] = v
            out_kinds[r] = k
    return responses, out_kinds


def sequential_sharded_reference(kind, shard_lists, keys, ops, params, lanes):
    """Homogeneous wrapper of ``sequential_hetero_reference``."""
    return sequential_hetero_reference(
        (kind,) * len(shard_lists), shard_lists, keys, ops, params, lanes
    )


# ================================================================== runtime
def _init_meta(kinds: Sequence[str], device):
    n_shards = len(kinds)
    return {
        "phases": torch.zeros((n_shards,), dtype=torch.int32, device=device),
        "ops_combined": torch.zeros((n_shards,), dtype=torch.int32, device=device),
        "kind": torch.tensor([KIND_CODES[k] for k in kinds], dtype=torch.int32,
                             device=device),
    }


@dataclasses.dataclass
class OpVerdict:
    """Per-op detectability verdict reported by recovery."""

    applied: bool
    kind: Optional[int] = None
    resp: Optional[float] = None
    shard: Optional[int] = None


class ShardedDFCRuntime:
    """Many persistent DFC objects -- possibly of MIXED kinds -- behind one
    announcement fabric.

    Volatile path: ``step(keys, ops, params)``.  Durable path: threads
    ``announce`` batches; ``combine_phase`` combines every ready
    announcement across all shards and commits per shard; ``recover``
    rebuilds the fabric after a crash and reports per-thread, per-op
    detectability verdicts; ``replay_pending`` re-announces exactly the
    not-applied ops.  ``phase_loop`` fuses a whole schedule of phases into
    one device call and replays the serial durable schedule behind it.

    ``depth`` is the pipeline depth: a ``combine_phase`` dispatches a fresh
    chain and keeps up to ``depth - 1`` dispatched chains un-retired (their
    persists and commits deferred, retired oldest first); ``depth=1`` is the
    serial path and ``pipeline=True`` means ``depth=2``.  With ``chain > 1``
    each ready thread's announcement is its own batch of one dispatch,
    padded to ``chain`` batches with all-``OP_NONE`` pass-through batches.

    ``kind`` is one kind name (``rt.state`` is then the one shard-stacked
    state) or a per-shard list (``rt.state`` is the ``{kind: state}`` group
    dict).  ``device`` defaults to the card.  Contract: per shard,
    ``capacity >= committed size + lanes``.
    """

    def __init__(
        self,
        kind: Union[str, Sequence[str]],
        n_shards: int,
        capacity: int,
        lanes: int,
        *,
        backend: str = "kernel",
        fs: Optional[SimFS] = None,
        n_threads: int = 1,
        state=None,
        meta=None,
        n_buckets: Optional[int] = None,
        table=None,
        pipeline: bool = False,
        depth: Optional[int] = None,
        chain: int = 1,
        ring_slots: int = 2048,
        split_lanes: bool = False,
        obs=None,
        device="cuda",
    ):
        kinds = [kind] * n_shards if isinstance(kind, str) else list(kind)
        if len(kinds) != n_shards:
            raise ValueError("per-shard kind list must have n_shards entries")
        for k in kinds:
            if k not in STRUCTS:
                raise ValueError(f"unknown structure kind {k!r}")
        if lanes > capacity:
            raise ValueError("lanes must be <= per-shard capacity")
        self.device = resolve_device(device)
        self.kinds = kinds
        self.kind = kinds[0] if len(set(kinds)) == 1 else "mixed"
        self.n_shards = n_shards
        self.capacity = capacity
        self.lanes = lanes
        self.backend = backend
        self.fs = fs
        self.n_threads = n_threads
        self.n_buckets = int(n_buckets) if n_buckets is not None else n_shards
        if self.n_buckets < n_shards:
            raise ValueError("n_buckets must be >= n_shards")
        self.table = np.asarray(
            np.arange(self.n_buckets) % n_shards if table is None else table,
            np.int32,
        )
        if self.table.shape != (self.n_buckets,):
            raise ValueError("table must have n_buckets entries")
        self._table_dev = torch.from_numpy(self.table).to(self.device)
        self.r_epoch = 0  # routing epoch (even at rest; moves only on reshard)
        self._reshard_seq = 0
        # per-side lanes: ``lane_epochs`` mirrors each split shard's committed
        # ``[eH, eT]`` (even at rest), advanced in commit order by the retire
        # and drain paths; the device epoch runs free (+2 per touched phase)
        # and recovery rebuilds it as eH + eT
        self.split_lanes = bool(split_lanes)
        self.lane_epochs: Dict[int, List[int]] = {}
        if depth is None:
            depth = 2 if pipeline else 1
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = int(depth)
        self.pipeline = self.depth > 1
        self.chain = max(1, int(chain))
        self.ring = (
            init_announce_ring(ring_slots, device=self.device)
            if fs is not None else None
        )
        self._ring_tail = 0  # host mirror of the ring's absolute tail
        self._ring_spans: Dict[int, Tuple[int, int]] = {}  # thread -> (start, n)
        self._live: Dict[int, Dict[str, Any]] = {}  # thread -> announcement rec
        # host mirror of each announcement slot's token, read by the depth
        # guard in ``announce``
        self._slot_tokens: Dict[Tuple[int, int], int] = {}
        # dispatched, not yet retired chains, oldest first (= commit order)
        self._inflight: "collections.deque[Dict[str, Any]]" = collections.deque()
        # seconds ``_retire`` spent waiting for a dispatched chain's results
        # to reach the host
        self.retire_wait_s = 0.0
        # (thread, token) groups of the most recent dispatch, one per batch
        self.last_dispatch: List[Tuple[Tuple[int, int], ...]] = []
        self._elide: Dict[str, bytes] = {}  # rel path -> durable leaf digest
        self._elide_pending: Dict[str, bytes] = {}
        if state is None:
            self.groups = {
                k: init_sharded(k, len(ids), capacity, device=self.device)
                for k, ids in _group_ids(tuple(kinds)).items()
            }
        else:
            self.state = state
        self.meta = _init_meta(kinds, self.device) if meta is None else meta
        # a live observer is shared with the SimFS, so the persistence hooks
        # and the protocol events land in one timeline; the hooks run after
        # the counters, the injector and the durable work
        self.obs = obs if obs is not None else NULL_OBS
        if fs is not None and self.obs.enabled:
            fs.obs = self.obs
            self.obs.event(
                EV_TOPOLOGY,
                kinds=list(kinds),
                n_shards=n_shards,
                n_buckets=self.n_buckets,
                capacity=capacity,
                lanes=lanes,
                depth=self.depth,
                chain=self.chain,
                split_lanes=self.split_lanes,
            )

    # ----------------------------------------------------- state as groups
    @property
    def state(self):
        """Single stacked state for homogeneous fabrics, the ``{kind:
        stacked_state}`` group dict otherwise."""
        if len(self.groups) == 1:
            return next(iter(self.groups.values()))
        return self.groups

    @state.setter
    def state(self, value):
        if isinstance(value, dict):
            self.groups = dict(value)
        else:
            self.groups = {self.kinds[0]: value}

    def _row(self, s: int) -> int:
        """Local row of global shard ``s`` inside its kind group."""
        return _group_ids(tuple(self.kinds))[self.kinds[s]].index(s)

    def _shard_state(self, s: int):
        return shard_slice(self.groups[self.kinds[s]], self._row(s))

    def _set_shard_state(self, s: int, one) -> None:
        k, r = self.kinds[s], self._row(s)

        def put(leaf, v):
            out = leaf.clone()
            out[r] = v.to(leaf.device)
            return out

        self.groups[k] = map_state(put, self.groups[k], one)

    def shard_epochs(self) -> np.ndarray:
        """Per-global-shard epochs gathered from the kind groups."""
        out = np.zeros((self.n_shards,), np.int64)
        for k, ids in _group_ids(tuple(self.kinds)).items():
            out[np.asarray(ids)] = _to_np(self.groups[k].epoch)
        return out

    # ------------------------------------------------------------- routing
    def _upload(self, keys, ops, params):
        return (
            to_int32(_to_np(keys)).to(self.device),
            torch.from_numpy(_to_np(ops).astype(np.int32)).to(self.device),
            torch.from_numpy(_to_np(params).astype(np.float32)).to(self.device),
        )

    def route(self, keys, ops, params):
        k, o, p = self._upload(keys, ops, params)
        return route_batch(k, o, p, n_shards=self.n_shards, lanes=self.lanes,
                           table=self._table_dev)

    def route_host(self, keys) -> np.ndarray:
        return route_keys_host(keys, self.n_shards, self.table)

    def key_for_shard(self, s: int, start: int = 0) -> int:
        """Smallest key >= ``start`` that routes to shard ``s`` under the
        current table (host-side search)."""
        for base in range(start, start + (1 << 22), 4096):
            cand = np.arange(base, base + 4096, dtype=np.int64)
            hit = np.nonzero(self.route_host(cand) == s)[0]
            if hit.size:
                return int(cand[hit[0]])
        raise ValueError(f"no key routes to shard {s} (unrouted shard?)")

    # ------------------------------------------------------- volatile path
    def step(self, keys, ops, params):
        """One phase over a flat batch; returns device tensors
        ``(responses, kinds)``."""
        k, o, p = self._upload(keys, ops, params)
        self.groups, self.meta, resp, kinds = hetero_step(
            self.groups, self._table_dev, k, o, p, self.meta,
            kinds=tuple(self.kinds), lanes=self.lanes, backend=self.backend,
        )
        return resp, kinds

    # -------------------------------------------------------- announcements
    def _ann_path(self, t: int, slot: int) -> str:
        return f"tAnn/thread_{t}/ann{slot}.json"

    def _valid_path(self, t: int) -> str:
        return f"tAnn/thread_{t}/valid"

    def _read_valid(self, t: int) -> int:
        raw = self.fs.read(self._valid_path(t))
        return int(raw.decode()) if raw else 0

    def _read_ann(self, t: int, slot: int) -> Dict[str, Any]:
        raw = self.fs.read(self._ann_path(t, slot))
        return json.loads(raw.decode()) if raw else {"val": BOT, "token": -1}

    def announce(self, thread: int, keys, ops, params, token: int) -> None:
        """Thread-side announcement (paper lines 2-12): double-buffered
        record + valid selector, parallel pwb/pfence, MSB publish; the
        payload also lands in the device announcement ring.  Per-thread
        ``token``s must increase monotonically.

        Depth guard: the double-buffered records bound a thread to two
        outstanding batches.  When the slot this announcement reuses still
        belongs to a dispatched, un-retired chain, chains are retired in
        commit order until that batch's responses are durable -- the serial
        schedule's pwbs and pfences, only re-timed."""
        if self._inflight:
            n_op = 1 - (self._read_valid(thread) & 1)
            old_tok = self._slot_tokens.get((thread, n_op), -1)
            while old_tok >= 0 and self._chain_holding(thread, old_tok) is not None:
                self._retire(self._inflight.popleft())
        n_op, ann = self._announce_durable(thread, token, keys, ops, params)
        self._register_live(thread, n_op, token, ann["keys"], ann["ops"], ann["params"])

    def _announce_durable(self, thread: int, token: int, keys, ops, params
                          ) -> Tuple[int, Dict[str, Any]]:
        """The announce protocol's durable writes (paper lines 2-12): record
        into the inactive slot, pfence, valid flip, pfence, MSB publish --
        3 pwb + 2 pfence.  Returns ``(slot, record)``."""
        valid = self._read_valid(thread)
        n_op = 1 - (valid & 1)
        ann = {
            "token": token,
            "keys": [int(k) for k in _to_np(keys)],
            "ops": [int(o) for o in _to_np(ops)],
            "params": [float(p) for p in _to_np(params)],
            "val": BOT,
        }
        self.fs.write(
            self._ann_path(thread, n_op), json.dumps(ann).encode(), tag="announce"
        )
        self.fs.fsync([self._ann_path(thread, n_op)], tag="announce")
        self.fs.write(self._valid_path(thread), str(n_op).encode(), tag="announce")
        self.fs.fsync([self._valid_path(thread)], tag="announce")
        self.fs.write(
            self._valid_path(thread), str(2 | n_op).encode(), tag="announce"
        )  # MSB
        if self.obs.enabled:
            self.obs.event(EV_ANNOUNCE, thread=int(thread), token=int(token),
                           slot=n_op, n=len(ann["ops"]))
        return n_op, ann

    def _register_live(self, thread: int, slot: int, token: int, keys, ops, params
                       ) -> Dict[str, Any]:
        """Track a live (announced, not yet combined) batch: host metadata
        for routing/retire plus a device-ring span for the combine payload.
        When the ring has no room the payload stays host-side
        (``ring_start=None``) and the combine uploads it instead."""
        keys = np.asarray(keys, np.int64)
        ops = np.asarray(ops, np.int32)
        params = np.asarray(params, np.float32)
        n = int(ops.shape[0])
        start = None
        if self.ring is not None and n:
            slots = int(self.ring.keys.shape[0])
            spans = [v for t, v in self._ring_spans.items() if t != thread]
            oldest = min((s0 for s0, _ in spans), default=self._ring_tail)
            if ring_has_room(slots, self._ring_tail, oldest, n):
                # a split-lane fabric stages each op's lane (op code x target
                # shard kind) beside it, for lane-filtered drains
                lane_col = (
                    torch.from_numpy(self._op_lanes_host(ops, self.route_host(keys)))
                    if self.split_lanes else None
                )
                self.ring = ring_announce(
                    self.ring,
                    torch.from_numpy(keys.astype(np.int32)),
                    torch.from_numpy(ops),
                    torch.from_numpy(params),
                    lane_col,
                )
                start = self._ring_tail
                self._ring_tail += n
                self._ring_spans[thread] = (start, n)
            else:
                self._ring_spans.pop(thread, None)
        rec = {
            "token": int(token), "slot": int(slot), "n": n,
            "keys": keys, "ops": ops, "params": params, "ring_start": start,
        }
        self._live[thread] = rec
        self._slot_tokens[(thread, int(slot))] = int(token)
        return rec

    def ready_announcements(self) -> List[int]:
        out = []
        for t in range(self.n_threads):
            v = self._read_valid(t)
            if (v >> 1) & 1:
                ann = self._read_ann(t, v & 1)
                if ann.get("val") is BOT and ann.get("token", -1) >= 0:
                    out.append(t)
        return out

    # ------------------------------------------------------ durable layout
    def _epoch_path(self, s: int) -> str:
        return f"shard_{s}/cEpoch"

    def _slot_dir(self, s: int, epoch: int, nxt: bool) -> str:
        return f"shard_{s}/slot{(epoch // 2 + (1 if nxt else 0)) % 2}"

    def _read_shard_epoch(self, s: int) -> int:
        raw = self.fs.read(self._epoch_path(s))
        return int(raw.decode()) if raw else 0

    def _persist_shard(self, s: int, epoch_target: int, state=None,
                       counters=None) -> List[str]:
        """pwb shard ``s``'s post-combine (or given) state into its inactive
        slot, one ``.npy`` per leaf in field order plus ``meta.json``.

        Dirty-leaf elision: a leaf whose bytes already sit durably in this
        slot is not re-written (it stays listed in the manifest); digests
        join the elision cache only after the phase's pfence.
        """
        one = self._shard_state(s) if state is None else state
        slot = self._slot_dir(s, epoch_target - 2, nxt=True)
        files = []
        if counters is None:
            counters = (
                int(self.meta["phases"][s]),
                int(self.meta["ops_combined"][s]),
            )
        meta = {
            "kind": self.kinds[s],
            "epoch": epoch_target,
            "leaves": [],
            "phases": int(counters[0]),
            "ops_combined": int(counters[1]),
        }
        for i, leaf in enumerate(one.leaves()):
            arr = np.asarray(_to_np(leaf))
            rel = f"{slot}/leaf_{i}.npy"
            if self._write_elided(s, rel, arr):
                files.append(rel)
            meta["leaves"].append(
                {"file": f"leaf_{i}.npy", "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        rel = f"{slot}/meta.json"
        self.fs.write(rel, json.dumps(meta).encode(), tag="slot")
        files.append(rel)
        return files

    def _promote_elision(self) -> None:
        """Leaf digests written since the last pfence are durable now."""
        self._elide.update(self._elide_pending)
        self._elide_pending.clear()

    def _write_elided(self, s: int, rel: str, arr: np.ndarray) -> bool:
        """pwb one ``.npy`` leaf unless its bytes already sit durably at
        ``rel`` (dirty-leaf elision); True when it was written."""
        buf = io.BytesIO()
        np.save(buf, arr)
        data = buf.getvalue()
        digest = hashlib.blake2b(data, digest_size=16).digest()
        if self._elide.get(rel) == digest:
            self.obs.metrics.counter("elision_hit", shard=s)
            return False
        self.fs.write(rel, data, tag="slot")
        self._elide_pending[rel] = digest
        self.obs.metrics.counter("elision_miss", shard=s)
        return True

    # ------------------------------------------------------ per-side lanes
    def _is_split(self, s: int) -> bool:
        """Whether shard ``s`` commits through independent head/tail lanes."""
        return self.split_lanes and STRUCTS[self.kinds[s]].lane_splittable

    def _lane_epoch_pair(self, s: int) -> List[int]:
        """Host mirror of split shard ``s``'s committed ``[eH, eT]``."""
        return self.lane_epochs.setdefault(s, [0, 0])

    def _op_lanes_host(self, ops, shards) -> np.ndarray:
        """Per-op announcement lane: ``LANE_HEAD`` / ``LANE_TAIL`` by the
        TARGET shard's structure for ops on split shards, ``LANE_NONE``
        otherwise (the same op code can be head-side on one shard and
        tail-side on another)."""
        ops = np.asarray(ops, np.int32)
        shards = np.asarray(shards)
        out = np.full(ops.shape, LANE_NONE, np.int32)
        n = min(ops.shape[0], shards.shape[0])
        o, sh = ops[:n], shards[:n].astype(np.int64)
        valid = (o != OP_NONE) & (sh >= 0) & (sh < self.n_shards)
        for s in np.unique(sh[valid]):
            if self._is_split(int(s)):
                sel = valid & (sh == s)
                out[:n][sel] = lane_of_ops_host(self.kinds[int(s)], o[sel])
        return out

    def _lane_slot_dir(self, s: int, lane: int, lane_epoch: int, nxt: bool) -> str:
        """A lane's alternating slot dir, its parity from ITS OWN epoch."""
        p = (lane_epoch // 2 + (1 if nxt else 0)) % 2
        return f"shard_{s}/lane{_LANE_TAGS[lane]}{p}"

    def _read_lane_epochs(self, s: int) -> List[int]:
        """Durable ``[eH, eT]`` of a split shard (``[0, 0]`` if it never
        committed; ``[0, e]`` for the scalar epoch of a history from before
        the split, when every commit was one-lane)."""
        raw = self.fs.read(self._epoch_path(s))
        if not raw:
            return [0, 0]
        txt = raw.decode()
        if txt.lstrip().startswith("["):
            e = json.loads(txt)
            return [int(e[0]), int(e[1])]
        return [0, int(txt)]

    def _lane_mode(self, s: int, ops_host, kinds_host, shard_host, post_state) -> str:
        """Classify one batch's phase on split shard ``s``: ``"head"`` or
        ``"tail"`` (only that lane's epoch advances) or ``"handoff"`` (both
        lanes commit at once): when the batch mixes both sides, and when a
        head-side phase leaves the structure drained (head counter == tail
        counter), the moment the head lane has consumed all the tail lane
        published.  ``post_state`` is the shard's post-phase state on the
        host."""
        ops_a = np.asarray(ops_host, np.int32)
        kinds_a = np.asarray(kinds_host)[: ops_a.shape[0]]
        sel = (np.asarray(shard_host) == s) & (ops_a != OP_NONE) & (kinds_a != R_OVERFLOW)
        lanes = lane_of_ops_host(self.kinds[s], ops_a[sel])
        has_h = bool(np.any(lanes == LANE_HEAD))
        has_t = bool(np.any(lanes == LANE_TAIL))
        if has_h and has_t:
            return "handoff"
        ends = np.asarray(post_state.ends)
        active = (int(post_state.epoch) // 2) % 2
        if has_h and int(ends[active][0]) == int(ends[active][1]):
            return "handoff"
        return "head" if has_h else "tail"

    def _persist_split_shard(self, s: int, mode: str, lane_targets: Sequence[int],
                             state, counters) -> List[str]:
        """pwb split shard ``s``'s post-phase lane record(s) into their
        inactive lane slots (the split twin of ``_persist_shard``): only the
        committing lane(s) write, a lane that owns values writes
        ``values.npy`` (with dirty-leaf elision) beside its ``rec.json``."""
        one = map_state(_to_np, state if state is not None else self._shard_state(s))
        kind = self.kinds[s]
        active = (int(one.epoch) // 2) % 2
        ctr = (int(one.ends[active][0]), int(one.ends[active][1]))  # (head, tail)
        if counters is None:
            counters = (int(self.meta["phases"][s]), int(self.meta["ops_combined"][s]))
        commit_lanes = {"head": (LANE_HEAD,), "tail": (LANE_TAIL,),
                        "handoff": (LANE_HEAD, LANE_TAIL)}[mode]
        files: List[str] = []
        for lane in commit_lanes:
            target = int(lane_targets[lane])
            sdir = self._lane_slot_dir(s, lane, target - 2, nxt=True)
            if _LANE_WRITES_VALUES[kind][lane]:
                rel = f"{sdir}/values.npy"
                if self._write_elided(s, rel, np.asarray(one.values)):
                    files.append(rel)
            rec = {
                "kind": kind,
                "lane": _LANE_TAGS[lane],
                "epoch": target,
                "ctr": ctr[lane],
                "phases": int(counters[0]),
                "ops_combined": int(counters[1]),
            }
            rel = f"{sdir}/rec.json"
            self.fs.write(rel, json.dumps(rec).encode(), tag="slot")
            files.append(rel)
        return files

    def _commit_lane_epochs(self, s: int, mode: str, lane_targets: Sequence[int]) -> None:
        """Two-increment commit of a split shard's epoch pair: the pair with
        the advancing lane(s) odd, fsync (the commit point), then the even
        pair unsynced.  One file holds the pair, so a handoff's two lanes
        commit or roll back together."""
        t_h, t_t = int(lane_targets[LANE_HEAD]), int(lane_targets[LANE_TAIL])
        odd = [t_h - 1 if mode in ("head", "handoff") else t_h,
               t_t - 1 if mode in ("tail", "handoff") else t_t]
        path = self._epoch_path(s)
        self.fs.write(path, json.dumps(odd).encode(), tag="epoch")
        self.fs.fsync([path], tag="epoch")
        self.fs.write(path, json.dumps([t_h, t_t]).encode(), tag="epoch")
        self.lane_epochs[s] = [t_h, t_t]
        self.obs.event(EV_EPOCH, shard=s, epoch=t_h + t_t, lanes=[t_h, t_t], mode=mode)

    def _plan_lane_commit(self, s: int, ops_host, kinds_host, shard_host, post_state
                          ) -> Tuple[str, List[int]]:
        """One touched split shard's commit plan for one phase: ``(mode,
        [eH', eT'])``, the advancing lane(s) at the mirror + 2 and the
        quiescent lane at its committed epoch."""
        mode = self._lane_mode(s, ops_host, kinds_host, shard_host, post_state)
        e_h, e_t = self._lane_epoch_pair(s)
        return mode, [e_h + 2 if mode in ("head", "handoff") else e_h,
                      e_t + 2 if mode in ("tail", "handoff") else e_t]

    def _lane_targets_per_op(self, ops_host, shard_host,
                             plans: Dict[int, Tuple[str, List[int]]], fallback_targets
                             ) -> Tuple[List[int], List[int]]:
        """Per-op ``(targets, lanes)`` of the durable response record: an op
        on a split shard targets ITS LANE's post-phase epoch; an op on an
        unsplit shard keeps the scalar target, on ``LANE_NONE``."""
        shards_a = np.asarray(shard_host)
        lanes = self._op_lanes_host(ops_host, shards_a)
        targets: List[int] = []
        for j in range(lanes.shape[0]):
            s = int(shards_a[j])
            if lanes[j] == LANE_NONE:
                targets.append(int(fallback_targets[j]))
            else:
                pair = plans[s][1] if s in plans else self._lane_epoch_pair(s)
                targets.append(int(pair[lanes[j]]))
        return targets, [int(x) for x in lanes]

    def lane_stats(self) -> Optional[Dict[str, Any]]:
        """Per-lane snapshot (``None`` when lanes are off): the committed
        ``[eH, eT]`` per split shard and the per-lane backlog of announced,
        uncombined ops, for ``obs.observe_fabric`` and
        ``tools/fabric_top.py``."""
        if not self.split_lanes:
            return None
        epochs = {s: list(self._lane_epoch_pair(s))
                  for s in range(self.n_shards) if self._is_split(s)}
        backlog: Dict[int, List[int]] = {s: [0, 0] for s in epochs}
        if self.fs is not None:
            for t in self.ready_announcements():
                rec = self._live.get(t)
                if rec is None:
                    continue
                shards = self.route_host(rec["keys"])
                lanes = self._op_lanes_host(rec["ops"], shards)
                for j in range(lanes.shape[0]):
                    if lanes[j] != LANE_NONE:
                        backlog[int(shards[j])][int(lanes[j])] += 1
        return {"epochs": epochs, "backlog": backlog}

    # ------------------------------------------------ durable routing layout
    _REPOCH_PATH = "routing/rEpoch"
    _INTENT_PATH = "reshard/intent.json"

    def _routing_slot(self, repoch: int, nxt: bool) -> str:
        return f"routing/slot{(repoch // 2 + (1 if nxt else 0)) % 2}.json"

    def _routing_record(self, target: int, table, kinds) -> Dict[str, Any]:
        return {
            "epoch": target,
            "table": [int(x) for x in table],
            "kinds": list(kinds),
            "n_shards": len(kinds),
            "n_buckets": self.n_buckets,
            "capacity": self.capacity,
            "lanes": self.lanes,
            "split_lanes": self.split_lanes,
        }

    # --------------------------------------------------------- combine phase
    def _chain_holding(self, thread: int, token: int) -> Optional[Dict[str, Any]]:
        """The in-flight chain that dispatched (thread, token), if any."""
        for fl in self._inflight:
            for info in fl["batches"]:
                for seg in info["threads"]:
                    if seg["thread"] == thread and seg["token"] == token:
                        return fl
        return None

    def _collect_ready(self) -> List[Tuple[int, Dict[str, Any]]]:
        """Ready announcements as (thread, live-record) pairs, thread order,
        without the batches already dispatched into the pipeline."""
        inflight = {
            (seg["thread"], seg["token"])
            for fl in self._inflight for info in fl["batches"] for seg in info["threads"]
        }
        out = []
        for t in self.ready_announcements():
            rec = self._live.get(t)
            v = self._read_valid(t)
            if rec is None or rec["slot"] != (v & 1):
                # announced before this runtime object existed: rebuild the
                # live record from the durable mirror
                ann = self._read_ann(t, v & 1)
                rec = self._register_live(
                    t, v & 1, ann["token"], ann["keys"], ann["ops"], ann["params"]
                )
            if (t, rec["token"]) not in inflight:
                out.append((t, rec))
        return out

    def _payload_view(self, rec: Dict[str, Any]):
        """A live batch's payload as device tensors: out of the announcement
        ring when the span landed there, a host upload otherwise."""
        if rec["ring_start"] is not None:
            return ring_drain(self.ring, rec["ring_start"], rec["n"])
        return (
            torch.from_numpy(rec["keys"].astype(np.int32)).to(self.device),
            torch.from_numpy(rec["ops"]).to(self.device),
            torch.from_numpy(rec["params"]).to(self.device),
        )

    def combine_phase(self) -> List[int]:
        """One durable combining phase over every ready announcement.

        Concatenates the announced batches in thread order (the combiner's
        walk over the announcement array) and dispatches the device combine
        on the ring-resident payload.  Retiring a chain persists every
        touched shard into its inactive slot, writes responses and per-op
        commit targets into the combined announcements, pfences ONCE (paper
        line 80), then commits each touched shard's epoch with the
        two-increment protocol (lines 81-83).

        At ``depth`` 1 the chain retires here.  At ``depth`` D > 1 the
        oldest chains are retired, in commit order, until at most D-1
        dispatched chains remain un-retired; a chain's responses become
        durable when it retires (a later ``combine_phase``, an ``announce``
        reclaiming its slot, or ``flush``).  With ``chain`` > 1 each ready
        thread's announcement is its own batch (the last one takes the
        rest), padded to ``chain`` batches with pass-through batches that
        cost no persistence op.  With nothing ready it flushes.  Returns the
        combined thread ids.
        """
        assert self.fs is not None, "combine_phase needs a SimFS"
        ready = self._collect_ready()
        if not ready:
            self.flush()
            return []

        if self.chain > 1:
            groups = [[r] for r in ready[: self.chain - 1]]
            if ready[self.chain - 1:]:
                groups.append(list(ready[self.chain - 1:]))
            groups += [[] for _ in range(self.chain - len(groups))]
        else:
            groups = [ready]

        maxlen = max(sum(rec["n"] for _, rec in g) for g in groups)
        pad = max(8, 1 << max(0, (maxlen - 1)).bit_length())
        dev_keys, dev_ops, dev_params, batches = [], [], [], []
        for g in groups:
            karrs, oarrs, parrs, segs, off = [], [], [], [], 0
            for t, rec in g:
                k, o, p = self._payload_view(rec)
                karrs.append(k)
                oarrs.append(o)
                parrs.append(p)
                segs.append({"thread": t, "token": rec["token"], "slot": rec["slot"],
                             "off": off, "n": rec["n"]})
                off += rec["n"]
                self._ring_spans.pop(t, None)  # span consumed at dispatch
            fill = pad - off
            if fill:
                karrs.append(torch.zeros((fill,), dtype=torch.int32, device=self.device))
                oarrs.append(torch.full((fill,), OP_NONE, dtype=torch.int32,
                                        device=self.device))
                parrs.append(torch.zeros((fill,), dtype=torch.float32, device=self.device))
            dev_keys.append(torch.cat(karrs))
            dev_ops.append(torch.cat(oarrs))
            dev_params.append(torch.cat(parrs))
            host_keys = (np.concatenate([rec["keys"] for _, rec in g])
                         if g else np.zeros((0,), np.int64))
            host_ops = (np.concatenate([rec["ops"] for _, rec in g])
                        if g else np.zeros((0,), np.int32))
            batches.append({"threads": segs, "shard": self.route_host(host_keys),
                            "ops": host_ops})

        (
            self.groups, self.meta, resp, out_kinds,
            states, epochs_before, epochs, phases_cum, ops_cum,
        ) = hetero_multi_step(
            self.groups, self._table_dev,
            torch.stack(dev_keys), torch.stack(dev_ops), torch.stack(dev_params),
            self.meta, kinds=tuple(self.kinds), lanes=self.lanes,
            backend=self.backend,
        )
        self._inflight.append(self._stage_to_host({
            "batches": batches, "resp": resp, "kinds": out_kinds,
            "states": states, "epochs_before": epochs_before,
            "epochs": epochs, "phases_cum": phases_cum, "ops_cum": ops_cum,
            "repoch": self.r_epoch,
        }))
        self.last_dispatch = [
            tuple((seg["thread"], seg["token"]) for seg in info["threads"])
            for info in batches
            if info["threads"]
        ]
        if self.obs.enabled:
            self.obs.event(
                EV_DISPATCH,
                batches=[[[seg["thread"], seg["token"]] for seg in info["threads"]]
                         for info in batches],
                inflight=len(self._inflight),
            )
            self.obs.metrics.gauge("inflight_chains", len(self._inflight))
        # retire the oldest chains, in commit order, while the device
        # combines: at most depth-1 chains stay in flight
        while len(self._inflight) > self.depth - 1:
            self._retire(self._inflight.popleft())
        if self.obs.enabled:
            self.obs.observe_fabric(self)
        return [seg["thread"] for info in batches for seg in info["threads"]]

    _STAGED = ("resp", "kinds", "epochs", "phases_cum", "ops_cum", "epochs_before")

    def _stage_to_host(self, fl: Dict[str, Any]) -> Dict[str, Any]:
        """Queue the copies of what ``_retire`` reads (responses, epochs,
        counters, per-batch states) into pinned host memory right behind
        the dispatch, and record an event after them.  ``_retire`` then waits
        on that event alone, not on everything queued since (a later chain's
        combine), so chain k's persistence overlaps chain k+1's combine on
        the card.  On the CPU there is nothing to stage."""
        if self.device.type != "cuda":
            return fl

        def pinned(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)

        for key in self._STAGED:
            fl[key] = pinned(fl[key])
        fl["states"] = {k: map_state(pinned, st) for k, st in fl["states"].items()}
        fl["ready"] = torch.cuda.Event()
        fl["ready"].record()
        return fl

    def _retire(self, fl: Dict[str, Any]) -> List[int]:
        """Persist + commit one dispatched chain, batch by batch: persist the
        touched shards into their inactive slots, write the responses into
        the combined announcements, ONE pfence, then the per-shard
        two-increment epoch commits -- the schedule (and pwb/pfence counts)
        of that many serial phases."""
        if "ready" in fl:
            t0 = time.perf_counter()
            fl["ready"].synchronize()
            self.retire_wait_s += time.perf_counter() - t0
        resp = _to_np(fl["resp"])
        kinds = _to_np(fl["kinds"])
        epochs = _to_np(fl["epochs"])  # [B, S]
        phases_cum = _to_np(fl["phases_cum"])
        ops_cum = _to_np(fl["ops_cum"])
        prev_epochs = _to_np(fl["epochs_before"])
        # one device->host fetch per stacked leaf (not per shard slice)
        states_np = {k: map_state(_to_np, st) for k, st in fl["states"].items()}

        def batch_shard_state(b, s):
            k, r = self.kinds[s], self._row(s)
            return map_state(lambda leaf: leaf[b, r], states_np[k])

        retired = []
        for b, info in enumerate(fl["batches"]):
            e_b = epochs[b]
            touched = [int(s) for s in np.nonzero(e_b != prev_epochs)[0]]
            if not info["threads"] and not touched:
                continue  # chain padding: no durable work
            files = self._commit_phase(
                b, touched, e_b, info["shard"], info["ops"], info["threads"], resp,
                kinds, phases_cum, ops_cum, batch_shard_state, fl["repoch"],
            )
            retired += [seg["thread"] for seg in info["threads"]]
            if self.obs.enabled:
                self.obs.event(
                    EV_RETIRE, batch=b,
                    threads=[[seg["thread"], seg["token"]] for seg in info["threads"]],
                    touched=touched, files=len(files),
                )
            prev_epochs = e_b
        return retired

    def _commit_phase(self, b, touched, e_b, shard, ops, segs, resp, kinds, phases_cum,
                      ops_cum, shard_state, repoch) -> List[str]:
        """The durable tail of one phase (retire and the fused drain share
        it): slot persists of the touched shards, response records of the
        combined announcements ``segs``, ONE pfence, then the per-shard
        two-increment epoch commits.  A touched split shard is planned first
        (which lane(s) advance, from the batch's op mix ``ops`` and the
        post-phase counters), persists its lane record(s) and commits its
        epoch pair; its ops target their lane's epoch.  Returns the files
        the phase's pfence covered."""
        kinds_row = kinds[b][: len(ops)]
        plans: Dict[int, Tuple[str, List[int]]] = {
            s: self._plan_lane_commit(s, ops, kinds_row, shard, shard_state(b, s))
            for s in touched if self._is_split(s)
        }
        files: List[str] = []
        for s in touched:
            counters = (phases_cum[b][s], ops_cum[b][s])
            if s in plans:
                files += self._persist_split_shard(s, *plans[s], state=shard_state(b, s),
                                                   counters=counters)
            else:
                files += self._persist_shard(s, int(e_b[s]), state=shard_state(b, s),
                                             counters=counters)
        fallback = e_b[shard]  # per-op commit target: its shard's epoch
        if self.split_lanes:
            targets, op_lanes = self._lane_targets_per_op(ops, shard, plans, fallback)
        else:
            targets, op_lanes = [int(e) for e in fallback], None
        for seg in segs:
            sl = slice(seg["off"], seg["off"] + seg["n"])
            ann = self._read_ann(seg["thread"], seg["slot"])
            ann["val"] = {
                "resp": [float(v) for v in resp[b][sl]],
                "kinds": [int(k) for k in kinds[b][sl]],
                "shards": [int(s) for s in shard[sl]],
                "targets": list(targets[sl]),
                "repoch": repoch,
            }
            if op_lanes is not None:
                ann["val"]["lanes"] = list(op_lanes[sl])
            rel = self._ann_path(seg["thread"], seg["slot"])
            self.fs.write(rel, json.dumps(ann).encode(), tag="resp")
            files.append(rel)
        self.fs.fsync(files, tag="phase")  # ONE pfence for slots + responses
        self._promote_elision()
        for s in touched:  # per-shard two-increment epoch commit
            if s in plans:
                self._commit_lane_epochs(s, *plans[s])
                continue
            e = int(e_b[s])
            self.fs.write(self._epoch_path(s), str(e - 1).encode(), tag="epoch")
            self.fs.fsync([self._epoch_path(s)], tag="epoch")
            self.fs.write(self._epoch_path(s), str(e).encode(), tag="epoch")
            self.obs.event(EV_EPOCH, shard=s, epoch=e)
        return files

    def flush(self) -> List[int]:
        """Retire every in-flight chain, oldest first: persist their shard
        states and responses and commit their epochs, in commit order.
        Returns the thread ids whose announcements became durable."""
        retired: List[int] = []
        while self._inflight:
            retired += self._retire(self._inflight.popleft())
        return retired

    def _drain(self) -> None:
        """Combine every ready announcement AND retire the pipeline."""
        self.combine_phase()
        self.flush()

    # ------------------------------------------------------ fused phase loop
    def phase_loop(self, schedule: Sequence[Tuple[int, int, Any, Any, Any]], *,
                   unroll: Optional[int] = None, phase_axis: str = "scan"
                   ) -> List[Dict[str, Any]]:
        """Fuse K combining phases into ONE device call, then drain the
        per-phase persist intents on the host in serial order.

        ``schedule`` is K entries ``(thread, token, keys, ops, params)``, each
        one thread's batch combined as its OWN phase (phase order = schedule
        order; per-thread tokens monotone, the ``announce`` contract).  The
        device side routes and combines every phase through
        ``hetero_phase_loop_step`` (``phase_axis="grid"``: one K-phase kernel
        launch per kind group; ``"scan"``: one one-phase launch per phase and
        kind), the schedule staged through the announcement ring in one
        scatter when it fits.  The host then replays, phase by phase, the
        serial durable schedule: the batch's durable announce (3 pwb + 2
        pfence), the touched shards' slot persists, the response record,
        ONE pfence, the per-shard two-increment epoch commits -- so commit
        order and the pwb/pfence counts are the serial path's exactly, and a
        crash anywhere in the drain leaves a log that ``recover`` /
        ``replay_pending`` handle as a serial run's.  ``unroll`` is the
        reference's scan-unroll knob and changes nothing here.

        Returns one response record per phase, in phase order: ``{"thread",
        "token", "resp", "kinds", "shards", "targets", "repoch"}``.
        """
        assert self.fs is not None, "phase_loop needs a SimFS"
        self._drain()  # quiescent start: nothing ready, nothing in flight
        if not schedule:
            return []

        k_phases = len(schedule)
        batches = [
            (int(t), int(tok), np.asarray(keys, np.int64), np.asarray(ops, np.int32),
             np.asarray(params, np.float32))
            for t, tok, keys, ops, params in schedule
        ]
        maxlen = max(b[3].shape[0] for b in batches)
        pad = max(8, 1 << max(0, (maxlen - 1)).bit_length())
        keys_h = np.zeros((k_phases, pad), np.int64)
        ops_h = np.full((k_phases, pad), OP_NONE, np.int32)
        params_h = np.zeros((k_phases, pad), np.float32)
        for j, (_, _, keys, ops, params) in enumerate(batches):
            n = ops.shape[0]
            keys_h[j, :n] = keys
            ops_h[j, :n] = ops
            params_h[j, :n] = params
        host = (torch.from_numpy(keys_h.astype(np.int32)), torch.from_numpy(ops_h),
                torch.from_numpy(params_h))

        # stage the whole schedule through the announcement ring (one scatter,
        # one phase-axis gather) when it fits; a host upload otherwise
        dev = None
        if self.ring is not None and k_phases * pad:
            slots = int(self.ring.keys.shape[0])
            oldest = min((s0 for s0, _ in self._ring_spans.values()),
                         default=self._ring_tail)
            if ring_has_room(slots, self._ring_tail, oldest, k_phases * pad):
                self.ring = ring_announce_phases(self.ring, *host)
                start = self._ring_tail
                self._ring_tail += k_phases * pad
                dev = ring_drain_phases(self.ring, start, k_phases, pad)
        if dev is None:
            dev = tuple(t.to(self.device) for t in host)

        (
            self.groups, self.meta, resp, out_kinds, states, epochs_before, intents,
        ) = hetero_phase_loop_step(
            self.groups, self._table_dev, dev[0], dev[1], dev[2], self.meta,
            kinds=tuple(self.kinds), lanes=self.lanes, backend=self.backend,
            unroll=self.depth if unroll is None else int(unroll),
            phase_axis=phase_axis,
        )
        self.last_dispatch = [((t, tok),) for t, tok, *_ in batches]
        if self.obs.enabled:
            self.obs.event(EV_DISPATCH, fused=True, k_phases=k_phases, pad=pad,
                           phase_axis=phase_axis,
                           batches=[[t, tok] for t, tok, *_ in batches])

        # the intent log on the host: one transfer per stacked leaf
        resp_np = _to_np(resp)
        kinds_np = _to_np(out_kinds)
        epochs = _to_np(intents.epoch)  # [K, S]
        phases_cum = _to_np(intents.phases_cum)
        ops_cum = _to_np(intents.ops_cum)
        prev_epochs = _to_np(epochs_before)
        states_np = {k: map_state(_to_np, st) for k, st in states.items()}

        def phase_shard_state(j, s):
            k, r = self.kinds[s], self._row(s)
            return map_state(lambda leaf: leaf[j, r], states_np[k])

        out_records: List[Dict[str, Any]] = []
        for j, (thread, token, keys, ops, params) in enumerate(batches):
            n = ops.shape[0]
            slot, _ = self._announce_durable(thread, token, keys, ops, params)
            self._slot_tokens[(thread, slot)] = token
            self._live[thread] = {
                "token": token, "slot": slot, "n": n,
                "keys": keys, "ops": ops, "params": params, "ring_start": None,
            }
            e_j = epochs[j]
            touched = [int(s) for s in np.nonzero(e_j != prev_epochs)[0]]
            seg = {"thread": thread, "token": token, "slot": slot, "off": 0, "n": n}
            files = self._commit_phase(j, touched, e_j, self.route_host(keys), ops, [seg],
                                       resp_np, kinds_np, phases_cum, ops_cum,
                                       phase_shard_state, self.r_epoch)
            if self.obs.enabled:
                self.obs.event(EV_DRAIN, phase=j, thread=thread, token=token,
                               touched=touched, files=len(files))
            prev_epochs = e_j
            out_records.append(
                dict(self._read_ann(thread, slot)["val"], thread=thread, token=token))
        if self.obs.enabled:
            self.obs.observe_fabric(self)
        return out_records

    def read_responses(self, thread: int, token: Optional[int] = None,
                       lane: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """A thread's combined announcement, or None while still pending.

        Returns ``{"token", "resp", "kinds", "shards", "targets", "repoch"}``
        (``"lanes"`` too on a split-lane fabric), the durable response
        record.  With ``token``, searches BOTH announcement slots for that
        batch.  With ``lane``, the record keeps only the ops that rode that
        announcement lane; the filter applies after the slot search and the
        staleness check, so a token is judged against the newest retained
        token of either lane.  Raises :class:`StaleTokenError` when
        ``token`` predates both retained slots.
        """

        def view(val: Dict[str, Any], tok: int):
            out = dict(val, token=tok)
            if lane is None:
                return out
            lanes = val.get("lanes")
            if lanes is None:
                lanes = [LANE_NONE] * len(val.get("kinds", []))
            idx = [i for i, ln in enumerate(lanes) if ln == lane]
            for key in ("resp", "kinds", "shards", "targets", "lanes"):
                if key in out and isinstance(out[key], list):
                    out[key] = [out[key][i] for i in idx]
            return out

        v = self._read_valid(thread)
        if token is None:
            ann = self._read_ann(thread, v & 1)
            if ann.get("val") is BOT:
                return None
            return view(ann["val"], ann["token"])
        held = []
        for slot in (v & 1, 1 - (v & 1)):
            ann = self._read_ann(thread, slot)
            t = ann.get("token", -1)
            if t == token:
                if ann.get("val") is BOT:
                    return None  # announced, not yet combined/retired
                return view(ann["val"], ann["token"])
            if t >= 0:
                held.append(t)
        # per-thread tokens are monotone: a token below the newest retained
        # one predates the retained slots for good
        if held and token < max(held):
            raise StaleTokenError(
                f"thread {thread} token {token} predates retained "
                f"announcement slot(s) (tokens held: {sorted(held)}); its "
                "response record was overwritten or never announced — read "
                "responses before announcing two successor batches"
            )
        return None

    # ----------------------------------------------------------- resharding
    def _snapshot_donor(self, s: int, op: str) -> None:
        """Detectable typed snapshot of the donor shard through the
        checkpoint manager's ``combine_structure``, on the fabric's SimFS
        (a fault sweep ticks through its persistence ops too)."""
        self._reshard_seq += 1
        mgr = DFCCheckpointManager(self.fs, 1, prefix="reshard/ckpt")
        e = mgr._read_epoch()
        if e % 2 == 1:  # a crash mid-snapshot left the log's epoch odd
            mgr._write_epoch(e + 1, sync=True)
        mgr.announce(0, {"step": self._reshard_seq})
        mgr.combine_structure(
            self._shard_state(s),
            extra_meta={"donor": int(s), "op": op, "repoch": self.r_epoch},
        )

    def _commit_routing(self, intent: Dict[str, Any], new_table: np.ndarray,
                        new_kinds: List[str], shard_files: List[str]) -> None:
        """Steps 3-5 of a reshard: the intent, pfence, the routing slot (and
        any slot files written before), ONE pfence, then the rEpoch
        two-increment commit, the transaction's commit point."""
        target = self.r_epoch + 2
        self.fs.write(self._INTENT_PATH, json.dumps(intent).encode(), tag="routing")
        self.fs.fsync([self._INTENT_PATH], tag="routing")
        slot = self._routing_slot(self.r_epoch, nxt=True)
        self.fs.write(
            slot,
            json.dumps(self._routing_record(target, new_table, new_kinds)).encode(),
            tag="routing",
        )
        self.fs.fsync(shard_files + [slot], tag="routing")
        self.fs.write(self._REPOCH_PATH, str(target - 1).encode(), tag="routing")
        self.fs.fsync([self._REPOCH_PATH], tag="routing")
        self.fs.write(self._REPOCH_PATH, str(target).encode(), tag="routing")
        if self.obs.enabled:
            self.obs.event(EV_RESHARD, op=intent.get("op"), target_repoch=target,
                           n_shards=len(new_kinds))

    def _set_table(self, table: np.ndarray) -> None:
        self.table = table
        self._table_dev = torch.from_numpy(table).to(self.device)

    def split_shard(self, donor: int) -> int:
        """Split a hot shard: half of the donor's buckets move to a NEW empty
        shard of the same kind.  Crash-consistent (commit point: rEpoch);
        the donor's contents stay put, only future routing changes.  In
        memory the kind's group gains one row (one copy of the group).
        Returns the new shard id."""
        buckets = [b for b in range(self.n_buckets) if self.table[b] == donor]
        if len(buckets) < 2:
            raise ValueError(
                f"shard {donor} holds {len(buckets)} bucket(s); construct the "
                "fabric with n_buckets > n_shards to make shards splittable"
            )
        kind = self.kinds[donor]
        new_id = self.n_shards
        new_table = self.table.copy()
        new_table[buckets[1::2]] = new_id
        new_kinds = self.kinds + [kind]

        if self.fs is not None:
            self._drain()  # drain ready announcements AND the pipeline
            self._snapshot_donor(donor, "split")
            intent = {
                "op": "split",
                "donor": int(donor),
                "new_shard": new_id,
                "kind": kind,
                "pre_repoch": self.r_epoch,
                "target_repoch": self.r_epoch + 2,
                "target_epochs": {},  # a split moves no shard state
            }
            # the new shard needs no durable state: no cEpoch means epoch 0,
            # no slot a fresh init on recovery
            self._commit_routing(intent, new_table, new_kinds, [])
            self.fs.delete(self._INTENT_PATH)

        fresh = STRUCTS[kind].init(self.capacity, device=self.device)
        self.groups[kind] = map_state(lambda leaf, f: torch.cat([leaf, f[None]]),
                                      self.groups[kind], fresh)
        self.kinds = new_kinds
        self.n_shards += 1
        self._set_table(new_table)
        self.r_epoch += 2
        new_row = _init_meta([kind], self.device)
        self.meta = {
            key: torch.cat([col, new_row.get(key, torch.zeros((1,), dtype=col.dtype,
                                                              device=col.device))])
            for key, col in self.meta.items()
        }
        return new_id

    def merge_shards(self, src: int, dst: int) -> None:
        """Merge a cold shard into another of the SAME kind: ``dst`` absorbs
        ``src``'s committed contents (appended after its own), ``src``
        empties and its buckets re-route to ``dst``; ``src``'s id stays
        allocated but unrouted, so recorded verdicts never dangle.  Both
        post-merge states are pwb'd and pfenced before the rEpoch commit;
        split-lane shards persist both lanes handoff-style and the intent
        records their lane pairs."""
        if src == dst:
            raise ValueError("cannot merge a shard into itself")
        if self.kinds[src] != self.kinds[dst]:
            raise ValueError(
                f"kind mismatch: shard {src} is {self.kinds[src]!r}, "
                f"shard {dst} is {self.kinds[dst]!r}"
            )
        kind = self.kinds[src]
        if self.fs is not None:
            self._drain()  # drain ready announcements AND the pipeline
        merged = self.shard_contents(dst) + self.shard_contents(src)
        if len(merged) + self.lanes > self.capacity:
            raise ValueError(
                f"merged contents ({len(merged)}) + lanes ({self.lanes}) "
                f"exceed capacity {self.capacity}"
            )
        epochs = self.shard_epochs()
        t_src, t_dst = int(epochs[src]) + 2, int(epochs[dst]) + 2
        src_new = state_from_contents(kind, [], self.capacity, t_src, device=self.device)
        dst_new = state_from_contents(kind, merged, self.capacity, t_dst, device=self.device)
        new_table = self.table.copy()
        new_table[new_table == src] = dst

        if self.fs is not None:
            self._snapshot_donor(src, "merge")
            split = self._is_split(src)
            if split:
                lane_targets = {sid: [e + 2 for e in self._lane_epoch_pair(sid)]
                                for sid in (src, dst)}
                intent_targets = {str(sid): list(lane_targets[sid]) for sid in (src, dst)}
            else:
                intent_targets = {str(src): t_src, str(dst): t_dst}
            intent = {
                "op": "merge",
                "src": int(src),
                "dst": int(dst),
                "kind": kind,
                "pre_repoch": self.r_epoch,
                "target_repoch": self.r_epoch + 2,
                "target_epochs": intent_targets,
            }
            if split:
                files = self._persist_split_shard(src, "handoff", lane_targets[src],
                                                  state=src_new, counters=None)
                files += self._persist_split_shard(dst, "handoff", lane_targets[dst],
                                                   state=dst_new, counters=None)
            else:
                files = self._persist_shard(src, t_src, state=src_new)
                files += self._persist_shard(dst, t_dst, state=dst_new)
            self._commit_routing(intent, new_table, self.kinds, files)
            self._promote_elision()
            for sid, tgt in ((src, t_src), (dst, t_dst)):
                if split:
                    self._commit_lane_epochs(sid, "handoff", lane_targets[sid])
                    continue
                self.fs.write(self._epoch_path(sid), str(tgt - 1).encode(), tag="epoch")
                self.fs.fsync([self._epoch_path(sid)], tag="epoch")
                self.fs.write(self._epoch_path(sid), str(tgt).encode(), tag="epoch")
                self.obs.event(EV_EPOCH, shard=sid, epoch=tgt)
            self.fs.delete(self._INTENT_PATH)

        self._set_shard_state(src, src_new)
        self._set_shard_state(dst, dst_new)
        self._set_table(new_table)
        self.r_epoch += 2

    # -------------------------------------------------------------- recover
    def _load_split_shard(self, s: int, pair: Sequence[int]):
        """Reassemble split shard ``s`` from its two ACTIVE lane records at
        the committed ``pair``: head and tail counters from each lane's
        ``ctr``, values from the values-owning lane whose record carries the
        larger ``phases`` (the last committed copy); then collect the lane
        slots.  Returns ``(state, (phases, ops_combined))``."""
        fs, kind = self.fs, self.kinds[s]
        fresh = map_state(_to_np, STRUCTS[kind].init(self.capacity, device="cpu"))
        recs: List[Optional[Dict[str, Any]]] = [None, None]
        live = set()
        for lane in (LANE_HEAD, LANE_TAIL):
            adir = self._lane_slot_dir(s, lane, pair[lane], nxt=False)
            raw = fs.read_durable(f"{adir}/rec.json")
            if raw:
                recs[lane] = json.loads(raw.decode())
                live.add(f"{adir}/rec.json")
                if _LANE_WRITES_VALUES[kind][lane]:
                    live.add(f"{adir}/values.npy")
        h = int(recs[LANE_HEAD]["ctr"]) if recs[LANE_HEAD] else int(fresh.ends[0][0])
        t = int(recs[LANE_TAIL]["ctr"]) if recs[LANE_TAIL] else int(fresh.ends[0][1])
        values = fresh.values
        best = (-1, None)
        for lane in (LANE_HEAD, LANE_TAIL):
            r = recs[lane]
            if r is None or not _LANE_WRITES_VALUES[kind][lane]:
                continue
            if int(r.get("phases", 0)) > best[0]:
                adir = self._lane_slot_dir(s, lane, pair[lane], nxt=False)
                best = (int(r.get("phases", 0)), f"{adir}/values.npy")
        if best[1] is not None:
            raw_v = fs.read_durable(best[1])
            if raw_v:
                values = np.load(io.BytesIO(raw_v))
        dev = self.device
        state = STRUCTS[kind].state_cls(
            values=torch.from_numpy(np.array(values)).to(dev),
            ends=torch.tensor([[h, t], [h, t]], dtype=torch.int32, device=dev),
            epoch=torch.tensor(pair[0] + pair[1], dtype=torch.int32, device=dev),
        )
        held = [r for r in recs if r is not None]
        counters = (max((int(r.get("phases", 0)) for r in held), default=0),
                    max((int(r.get("ops_combined", 0)) for r in held), default=0))
        # GC: drop partial lane-slot writes of the interrupted phase
        for lane in (LANE_HEAD, LANE_TAIL):
            for p in (0, 1):
                for rel in list(fs.listdir(f"shard_{s}/lane{_LANE_TAGS[lane]}{p}")):
                    if rel not in live:
                        fs.delete(rel)
        return state, counters

    @classmethod
    def recover(
        cls,
        fs: SimFS,
        *,
        kind: Union[str, Sequence[str]] = "queue",
        n_shards: int = 1,
        capacity: int,
        lanes: int,
        backend: str = "kernel",
        n_threads: int = 1,
        n_buckets: Optional[int] = None,
        table=None,
        pipeline: bool = False,
        depth: Optional[int] = None,
        chain: int = 1,
        ring_slots: int = 2048,
        split_lanes: bool = False,
        obs=None,
        device="cuda",
    ) -> Tuple["ShardedDFCRuntime", Dict[int, Dict[str, Any]]]:
        """Recover the fabric + per-thread/per-op detectability report.

        Topology first: the committed routing record (a fabric that
        resharded) overrides the caller's ``kind`` / ``n_shards`` /
        ``n_buckets`` / ``table`` / ``split_lanes``.  An interrupted reshard
        is resolved by its intent: rolled forward when ``rEpoch`` reached
        its target (the touched shards' epochs, a lane pair componentwise),
        rolled back otherwise (the per-shard GC reclaims its slot writes).

        Per shard: round an odd durable epoch up to even (finish the
        interrupted second increment, paper lines 28-30), garbage-collect
        the inactive slot, and reload the active slot (or a fresh init when
        the shard never committed); a split shard rounds each odd lane
        component up and reassembles its state from its two active lane
        records.  Per announced op: applied iff its shard's committed epoch
        (its lane's, for a split-lane op) reached the target recorded with
        the response; everything else is reported not-applied and is safe to
        re-announce (``replay_pending``).

        A live ``obs`` is attached first, so recovery's own repair writes
        join the timeline the crashed run left (the recorder continues the
        sidecar's ``seq``); recovery then adds one verdict event per
        announced thread and flushes the sidecar.
        """
        obs = obs if obs is not None else NULL_OBS
        if obs.enabled:
            fs.obs = obs
            obs.event(EV_RECOVER, stage="begin")

        # routing epoch: round odd up (finish the second increment)
        raw = fs.read(cls._REPOCH_PATH)
        repoch = int(raw.decode()) if raw else 0
        if repoch % 2 == 1:
            repoch += 1
            fs.write(cls._REPOCH_PATH, str(repoch).encode(), tag="recovery")
            fs.fsync([cls._REPOCH_PATH], tag="recovery")

        # adopt the committed routing record, if any
        kinds = [kind] * n_shards if isinstance(kind, str) else list(kind)
        rec_raw = fs.read(f"routing/slot{(repoch // 2) % 2}.json")
        if rec_raw:
            rec = json.loads(rec_raw.decode())
            kinds = list(rec["kinds"])
            n_shards = int(rec["n_shards"])
            n_buckets = int(rec["n_buckets"])
            capacity = int(rec.get("capacity", capacity))
            lanes = int(rec.get("lanes", lanes))
            split_lanes = bool(rec.get("split_lanes", split_lanes))
            table = np.asarray(rec["table"], np.int32)

        # resolve an interrupted reshard by its intent record
        intent_raw = fs.read(cls._INTENT_PATH)
        if intent_raw:
            intent = json.loads(intent_raw.decode())
            if intent["target_repoch"] <= repoch:
                # committed: roll the touched shards' epochs forward (their
                # slot data was pfenced before the commit point); a lane
                # pair rolls componentwise and stays in one file
                for sid_str, tgt in intent.get("target_epochs", {}).items():
                    p = f"shard_{int(sid_str)}/cEpoch"
                    raw_e = fs.read(p)
                    if isinstance(tgt, list):
                        txt = raw_e.decode() if raw_e else ""
                        cur = (json.loads(txt) if txt.lstrip().startswith("[")
                               else [0, int(txt)] if txt else [0, 0])
                        new = [max(int(cur[i]), int(tgt[i])) for i in (0, 1)]
                        if new != [int(cur[0]), int(cur[1])]:
                            fs.write(p, json.dumps(new).encode(), tag="recovery")
                            fs.fsync([p], tag="recovery")
                        continue
                    cur = int(raw_e.decode()) if raw_e else 0
                    if cur < int(tgt):
                        fs.write(p, str(int(tgt)).encode(), tag="recovery")
                        fs.fsync([p], tag="recovery")
            else:
                # aborted: routing and shard epochs are still pre-reshard;
                # drop the half-written inactive routing slot
                fs.delete(f"routing/slot{(repoch // 2 + 1) % 2}.json")
            fs.delete(cls._INTENT_PATH)

        rt = cls(
            kinds, n_shards, capacity, lanes,
            backend=backend, fs=fs, n_threads=n_threads,
            n_buckets=n_buckets, table=table,
            pipeline=pipeline, depth=depth, chain=chain, ring_slots=ring_slots,
            split_lanes=split_lanes, obs=obs, device=device,
        )
        rt.r_epoch = repoch

        shard_states = []
        phases = np.zeros((n_shards,), np.int32)
        ops_combined = np.zeros((n_shards,), np.int32)
        committed_epochs = np.zeros((n_shards,), np.int64)
        committed_lane_epochs: Dict[int, List[int]] = {}
        for s in range(n_shards):
            spec = STRUCTS[kinds[s]]
            if rt._is_split(s):
                pair = rt._read_lane_epochs(s)
                if any(e % 2 == 1 for e in pair):
                    pair = [e + (e % 2) for e in pair]
                    fs.write(rt._epoch_path(s), json.dumps(pair).encode(), tag="recovery")
                    fs.fsync([rt._epoch_path(s)], tag="recovery")
                committed_lane_epochs[s] = list(pair)
                rt.lane_epochs[s] = list(pair)
                committed_epochs[s] = pair[0] + pair[1]
                state, counters = rt._load_split_shard(s, pair)
                shard_states.append(state)
                phases[s], ops_combined[s] = counters
                continue
            epoch = rt._read_shard_epoch(s)
            if epoch % 2 == 1:  # crashed between the two increments
                epoch += 1
                fs.write(rt._epoch_path(s), str(epoch).encode(), tag="recovery")
                fs.fsync([rt._epoch_path(s)], tag="recovery")
            committed_epochs[s] = epoch
            active = rt._slot_dir(s, epoch, nxt=False)
            inactive = rt._slot_dir(s, epoch, nxt=True)
            meta_raw = fs.read_durable(f"{active}/meta.json")
            live = {f"{active}/meta.json"}
            if meta_raw:
                meta = json.loads(meta_raw.decode())
                live |= {f"{active}/{e['file']}" for e in meta["leaves"]}
                leaves = [
                    np.load(io.BytesIO(fs.read_durable(f"{active}/{e['file']}")))
                    for e in meta["leaves"]
                ]
                shard_states.append(spec.state_cls(*[
                    torch.from_numpy(leaf).to(rt.device) for leaf in leaves
                ]))
                phases[s] = meta.get("phases", 0)
                ops_combined[s] = meta.get("ops_combined", 0)
            else:
                shard_states.append(spec.init(capacity, device=rt.device))
            # GC: drop partial writes of the interrupted phase
            for rel in list(fs.listdir(active)) + list(fs.listdir(inactive)):
                if rel not in live:
                    fs.delete(rel)

        rt.groups = {
            k: stack_shards([shard_states[s] for s in ids])
            for k, ids in _group_ids(tuple(kinds)).items()
        }
        rt.meta = {
            "phases": torch.from_numpy(phases).to(rt.device),
            "ops_combined": torch.from_numpy(ops_combined).to(rt.device),
            "kind": torch.tensor([KIND_CODES[k] for k in kinds], dtype=torch.int32,
                                 device=rt.device),
        }

        def _slot_verdicts(ann) -> Tuple[List[OpVerdict], bool]:
            """Per-op verdicts of one announcement record + whether its
            phase fully committed (every target epoch reached)."""
            verdicts: List[OpVerdict] = []
            val = ann.get("val")
            n_ops = len(ann.get("ops", []))
            if val is BOT:
                return [OpVerdict(applied=False) for _ in range(n_ops)], False
            op_lanes = val.get("lanes")
            fully = True
            for i in range(n_ops):
                s = val["shards"][i]
                k = val["kinds"][i]
                ln = op_lanes[i] if op_lanes is not None else LANE_NONE
                if ln != LANE_NONE and s in committed_lane_epochs:
                    # a split-lane op commits with its lane's epoch component
                    committed = committed_lane_epochs[s][ln] >= val["targets"][i]
                else:
                    committed = committed_epochs[s] >= val["targets"][i]
                fully = fully and bool(committed)
                applied = bool(committed) and k != R_OVERFLOW and k != R_NONE
                verdicts.append(
                    OpVerdict(
                        applied=applied,
                        kind=k if committed else None,
                        resp=val["resp"][i] if committed else None,
                        shard=s,
                    )
                )
            return verdicts, fully

        report: Dict[int, Dict[str, Any]] = {}
        for t in range(n_threads):
            v = rt._read_valid(t)
            lsb = v & 1
            if (v >> 1) & 1 == 0:  # re-publish a half-written valid selector
                fs.write(rt._valid_path(t), str(2 | lsb).encode(), tag="recovery")
            ann = rt._read_ann(t, lsb)
            if ann.get("token", -1) < 0:
                report[t] = {"token": None, "ops": [], "prev": None}
                continue
            verdicts, _ = _slot_verdicts(ann)
            # the OLDER slot may hold a predecessor that never fully
            # committed; only a SMALLER token qualifies (tokens are monotone)
            prev = None
            pann = rt._read_ann(t, 1 - lsb)
            ptok = pann.get("token", -1)
            if 0 <= ptok < ann["token"] and pann.get("ops"):
                pverdicts, pfully = _slot_verdicts(pann)
                if not pfully:
                    prev = {"token": ptok, "ops": pverdicts}
            report[t] = {"token": ann["token"], "ops": verdicts, "prev": prev}
            if ann.get("val") is BOT:
                # still pending: re-stage it so a combine_phase runs unchanged
                rt._register_live(
                    t, lsb, ann["token"], ann["keys"], ann["ops"], ann["params"]
                )
        if obs.enabled:
            for t, rep in report.items():
                if rep["token"] is None:
                    continue
                obs.event(
                    EV_VERDICT, thread=t, token=rep["token"],
                    applied=[bool(v.applied) for v in rep["ops"]],
                    prev_token=(rep["prev"] or {}).get("token"),
                    prev_applied=[bool(v.applied)
                                  for v in (rep["prev"] or {}).get("ops", [])],
                )
            obs.event(
                EV_RECOVER, stage="end", repoch=repoch,
                epochs=[int(e) for e in committed_epochs],
                threads=sum(1 for r in report.values() if r["token"] is not None),
            )
            obs.flush()
        return rt, report

    def replay_pending(self, report: Dict[int, Dict[str, Any]]) -> List[int]:
        """Re-announce exactly the not-applied ops of every thread (read back
        from the durable records) and run one combining phase -- the
        exactly-once resume step after a crash.  Ops that committed with an
        ``R_NONE`` response are not replayed (they completed as no-ops);
        uncommitted ops and ``R_OVERFLOW`` rejections are.  A reported
        predecessor batch (``report[t]["prev"]``) is replayed in a round of
        its own first, so per-thread op order survives.  Returns the
        replayed thread ids."""

        def _redo(ann, verdicts):
            if not ann.get("ops"):
                return None
            idx = [
                i for i, v in enumerate(verdicts)
                if not v.applied and v.kind != R_NONE
            ]
            if not idx:
                return None
            return (
                [ann["keys"][i] for i in idx],
                [ann["ops"][i] for i in idx],
                [ann["params"][i] for i in idx],
            )

        # snapshot both slots' durable records BEFORE any re-announcement
        prev_round: List[Tuple[int, int, Tuple]] = []
        newest_round: List[Tuple[int, int, Dict[str, Any], List[OpVerdict]]] = []
        for t in sorted(report):
            r = report[t]
            lsb = self._read_valid(t) & 1
            prev = r.get("prev")
            if prev is not None:
                pann = self._read_ann(t, 1 - lsb)
                if pann.get("token", -1) == prev["token"]:
                    redo = _redo(pann, prev["ops"])
                    if redo is not None:
                        prev_round.append((t, prev["token"], redo))
            if r["token"] is None:
                continue
            ann = self._read_ann(t, lsb)
            if _redo(ann, r["ops"]) is not None:
                newest_round.append((t, r["token"], ann, r["ops"]))

        replayed = set()
        for t, token, (keys, ops, params) in prev_round:
            self.announce(t, keys, ops, params, token=token)
            replayed.add(t)
        if prev_round:
            self._drain()

        # a still-PENDING newest announcement may have been combined by
        # round 1's phase; then only its R_OVERFLOW rejections need a replay
        for t, token, ann, verdicts in newest_round:
            pre_combined = any(v.shard is not None for v in verdicts)
            if not pre_combined:
                val = self.read_responses(t, token=token)
                if val is not None:
                    idx = [
                        i for i, k in enumerate(val["kinds"]) if k == R_OVERFLOW
                    ]
                    if not idx:
                        continue
                    self.announce(
                        t,
                        [ann["keys"][i] for i in idx],
                        [ann["ops"][i] for i in idx],
                        [ann["params"][i] for i in idx],
                        token=token,
                    )
                    replayed.add(t)
                    continue
            keys, ops, params = _redo(ann, verdicts)
            self.announce(t, keys, ops, params, token=token)
            replayed.add(t)
        if replayed:
            self._drain()
        return sorted(replayed)

    # -------------------------------------------------------------- helpers
    def shard_contents(self, s: int) -> List:
        """Committed contents of shard ``s`` (bottom-to-top / left-to-right;
        ``(key, value)`` pairs for a map)."""
        one = map_state(_to_np, self._shard_state(s))
        active = (int(one.epoch) // 2) % 2
        if self.kinds[s] == "stack":
            return [float(v) for v in one.values[: int(one.size[active])]]
        if self.kinds[s] == "map":
            return [
                (int(one.keys[i]), float(one.values[i]))
                for i in range(one.occupied.shape[0])
                if one.occupied[i]
            ]
        cap = one.values.shape[0]
        e = one.ends[active]
        return [float(one.values[i % cap]) for i in range(int(e[0]), int(e[1]))]

    def shard_sizes(self) -> np.ndarray:
        """Committed sizes of every shard, from the active root counters."""
        out = np.zeros((self.n_shards,), np.int64)
        for k, ids in _group_ids(tuple(self.kinds)).items():
            st = map_state(_to_np, self.groups[k])
            rows = np.arange(len(ids))
            active = (st.epoch // 2) % 2
            if k == "stack":
                sizes = st.size[rows, active]
            elif k == "map":
                sizes = st.count[rows, active]
            else:
                ends = st.ends[rows, active]  # [Sg, 2]
                sizes = ends[:, 1] - ends[:, 0]
            out[np.asarray(ids)] = sizes
        return out
