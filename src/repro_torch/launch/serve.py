"""Serving launcher: the DFC request-queue tier + batched prefill/decode.

Counterpart of the JAX package's ``launch/serve.py``.  The sharded DFC
fabric (``runtime/dfc_shard.py``) is mounted as the serving tier's request
queue:

  * session ids are the routing keys; an arriving session is ENQUEUED into
    its request shard, and each prefill round DEQUEUES up to ``--batch``
    sessions into the model batch;
  * the pool of free decode slots is a LIFO **stack shard in the same
    fabric**, so arrivals and slot releases combine in one phase;
  * per-session serving state (priority class, decode-slot binding,
    lifecycle stage) lives in a **map shard of the same fabric**: arrival
    inserts it, admission binds the slot with a fabric CAS, service marks it
    SERVED, so ``recover()`` returns queues, slot pool and session table
    from one walk;
  * ``--priority`` runs the request shards as DEQUES (a high-priority
    session jumps the line with a front push); ``k_classes`` runs one FIFO
    shard per priority class with weighted round-robin admission;
  * ``--durable`` runs the tier over the announce/combine persistence path
    (SimFS) and reports pwb/op; ``--depth D`` pipelines it D chains deep;
    ``--bulk-arrivals`` commits the whole arrival schedule through the
    fabric's fused K-phase ``phase_loop``;
  * ``--state-dir`` + ``--crash-at K`` + ``--resume`` crash the tier at its
    K-th persistence op and recover, reconcile and finish serving with no
    session lost or duplicated (``--expect-exactly-once`` asserts it);
  * ``--k-classes k`` runs the continuous-batching server
    (``ContinuousServer``): k per-class request shards admitted by weighted
    round-robin (``--class-weights``), every active session decoding one
    ``--quantum`` of tokens per round, progress committed to the session
    map, the consumer's ``served.log`` / ``tokens.log`` outside the
    fault-injected store, and a crash resumed token-exactly;
  * ``--trace`` attaches the fabric's flight recorder (``obs``): a
    crash-durable trace sidecar under the tier root, metrics and Chrome
    trace exports, and admission / service / end-to-end latency p50/p99;
  * ``--split-lanes`` commits each request shard's arrivals (tail lane) and
    admissions (head lane) through their own records and epochs;
  * ``--reshard-backlog N`` splits a request shard whose backlog reaches N
    (crash-consistent: see ``ShardedDFCRuntime.split_shard``).

Each admitted batch (or, with ``--k-classes``, each session at batch 1) is
prefilled and greedily decoded by the port's model on the card
(``--device``, default ``cuda``): RMSNorm, prefill attention and the
selective scan run through the hand-written kernels.  The model's
configuration is ``--arch``'s (its smoke configuration with
``--reduced``), tuned as the reference's launcher tunes it
(``launch/tuned.py``: of its levers only ``moe_groups`` 16 for the MoE
archs changes the math on one card).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 8 --prompt-len 512 --gen 32 --sessions 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 16 --gen 8 --sessions 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --prompt-len 16 --gen 8 --sessions 12 --k-classes 3 \\
      --quantum 2 --durable --trace --state-dir D --crash-at 300 --device cpu

``--window W`` makes every decode step a rolling-window step over the
attention caches, as the reference's launcher does: the prefill still fills
an insert-at-length cache ``prompt_len + gen + 8`` wide, and the ring takes
its width from that cache, not from W (``models/model.py``).  So W itself is
ignored (only ``W > 0`` is read), and each step rolls that whole cache,
whose right end holds zeros where the prompt's keys should be: the window
attention differs from the full model's.  A prefill whose ``max_len`` is W,
then ``decode_step(window=W)``, is the well-defined ring.  The
frontend-stub archs (``musicgen-large``:
frame embeddings in; ``llama-3.2-vision-11b``: image embeddings beside the
tokens) are refused outside ``--tier-only``, as the reference's launcher
refuses them: drive their model through ``launch/steps.py`` with an
embeddings batch.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.dfc_checkpoint import CrashNow, FaultInjector, SimFS
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.torch_dfc import (
    CAS_DOM,
    OP_DEQ,
    OP_ENQ,
    OP_MAP_CAS,
    OP_MAP_INSERT,
    OP_MAP_LOOKUP,
    OP_POP,
    OP_POP_FRONT,
    OP_PUSH,
    OP_PUSH_BACK,
    OP_PUSH_FRONT,
    R_CAS_FAIL,
    R_VALUE,
    pack_cas,
)
from repro_torch.launch.tuned import apply_tuning
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.dfc_shard import (
    _HASH_MULT,
    R_OVERFLOW,
    ShardedDFCRuntime,
    _to_np,
    resolve_device,
    weighted_dequeue_plan,
)


# ------------------------------------------------- session-state map packing
# The tier keeps per-session serving state in a MAP SHARD of the same
# fabric, one entry per session.  The packed value fits in 12 bits so a
# whole-state swap rides a single fabric CAS (``pack_cas`` needs both sides
# < CAS_DOM):
#
#   bits 10..11  priority class (0 = lowest; the binary ``priority=True``
#                tier uses classes 0/1, ``k_classes=k`` uses 0..k-1, k <= 4)
#   bits 3..9    decode slot binding (SESSION_SLOT_NONE = unbound)
#   bits 0..2    stage: QUEUED -> ADMITTED -> SERVED
SESSION_QUEUED, SESSION_ADMITTED, SESSION_SERVED = 1, 2, 3
SESSION_STAGE_DOM = 8
SESSION_SLOT_DOM = 128
SESSION_CLASS_DOM = 4
SESSION_MAX_CLASSES = SESSION_CLASS_DOM
SESSION_SLOT_NONE = SESSION_SLOT_DOM - 1
# Decode PROGRESS (tokens emitted so far) rides a SECOND map entry per
# session, tagged by value range: state entries are < CAS_DOM, progress
# entries are stored as PROGRESS_TAG + tokens (tokens < PROGRESS_MAX keeps
# the stored value inside f32's contiguous-integer range).
PROGRESS_TAG = CAS_DOM
PROGRESS_MAX = CAS_DOM * CAS_DOM - PROGRESS_TAG
# Each session owns the key window [sid * stride, (sid + 1) * stride): its
# state key is the FIRST window key routing to the session shard and its
# progress key the SECOND, so map keys are unique by construction and the
# recovery walk inverts them: sid = key // stride.
_SESSION_KEY_STRIDE = 64


def pack_session(cls: int, slot: int, stage: int) -> int:
    """Pack (priority class, slot, stage) into one CAS-swappable map value;
    every field is range-checked."""
    cls, slot, stage = int(cls), int(slot), int(stage)
    if not 0 <= cls < SESSION_CLASS_DOM:
        raise ValueError(f"priority class {cls} outside [0, {SESSION_CLASS_DOM})")
    if not 0 <= slot < SESSION_SLOT_DOM:
        raise ValueError(f"decode slot {slot} outside [0, {SESSION_SLOT_DOM})")
    if not 0 <= stage < SESSION_STAGE_DOM:
        raise ValueError(f"stage {stage} outside [0, {SESSION_STAGE_DOM})")
    packed = cls * (SESSION_SLOT_DOM * SESSION_STAGE_DOM) + slot * SESSION_STAGE_DOM + stage
    assert packed < CAS_DOM, (cls, slot, stage)  # CAS-swappable by design
    return packed


def unpack_session(packed) -> Dict[str, int]:
    p = int(packed)
    if not 0 <= p < CAS_DOM:
        raise ValueError(f"packed session state {p} outside [0, {CAS_DOM})")
    cls = p // (SESSION_SLOT_DOM * SESSION_STAGE_DOM)
    return {
        "cls": cls,
        # binary view: any class above the lowest counts as priority
        "priority": 1 if cls > 0 else 0,
        "slot": (p // SESSION_STAGE_DOM) % SESSION_SLOT_DOM,
        "stage": p % SESSION_STAGE_DOM,
    }


class RequestQueueTier:
    """Session admission over a heterogeneous DFC fabric.

    ``n_queues`` request shards (FIFO queues, or DEQUES when
    ``priority=True``) plus ONE stack shard (the free-slot pool) plus ONE
    map shard (per-session serving state) behind a single router.  Bucket 0
    of the routing table is pinned to the pool shard and every fourth bucket
    to the session shard; session ids are re-probed away from both, so every
    session key lands on a request shard.  All tier traffic flows through
    the fabric's combine, volatile (``step``) or durable (``announce`` /
    ``combine_phase``), and a recovered tier restores queues, pool and
    session table from one fabric walk.

    Priority admission (``priority=True``): a session with priority > 0 is
    pushed at the FRONT of its request deque and dequeues ahead of the whole
    backlog; the order is fabric state and survives crash/recover.

    k-class admission (``k_classes=k``, 2 <= k <= ``SESSION_MAX_CLASSES``):
    one FIFO request shard per class (shard ``c`` <-> class ``c``), admitted
    by weighted round-robin (``weighted_dequeue_plan``): class ``c`` holds
    ``class_weights[c]`` credits per cycle, and a backlogged class is never
    passed over for more than ``sum(weights) - weights[c]`` consecutive
    admissions (``starvation_bound()``).  The cycle cursor is host state and
    restarts at the cycle head on recovery.

    ``obs`` (a ``FabricObserver``) is shared with the fabric: request
    lifecycle events and the latency histograms of ``latency_stats`` land
    beside the durable path's events.  ``device`` is where the fabric lives
    (default the card).  ``split_lanes`` gives every request shard per-side
    lanes (arrivals on the tail lane, admissions on the head lane); with
    ``reshard_backlog`` the hottest request shard splits once its backlog
    reaches that many sessions.
    """

    def __init__(
        self,
        n_queues: int = 4,
        slots: int = 4,
        *,
        capacity: int = 4096,
        lanes: int = 64,
        durable: bool = False,
        fs: Optional[SimFS] = None,
        reshard_backlog: Optional[int] = None,
        n_buckets: Optional[int] = None,
        pipeline: bool = False,
        depth: Optional[int] = None,
        priority: bool = False,
        k_classes: int = 0,
        class_weights: Optional[Sequence[int]] = None,
        split_lanes: bool = False,
        obs=None,
        device="cuda",
        _seed_slots: bool = True,
        _rt: Optional[ShardedDFCRuntime] = None,
    ):
        if k_classes and k_classes >= 2:
            if priority:
                raise ValueError("k_classes generalizes priority=True; pick one")
            if k_classes > SESSION_MAX_CLASSES:
                raise ValueError(
                    f"k_classes={k_classes} exceeds the packed class field "
                    f"(SESSION_MAX_CLASSES={SESSION_MAX_CLASSES})"
                )
            if reshard_backlog is not None:
                raise ValueError(
                    "k_classes pins shard c to class c; autosplit would "
                    "break the mapping (reshard_backlog must be None)"
                )
            n_queues = k_classes  # shard c == class c
            self.k_classes = k_classes
            self.class_weights = (
                [int(w) for w in class_weights]
                if class_weights is not None
                else [1 << c for c in range(k_classes)]
            )
            if len(self.class_weights) != k_classes or any(
                w < 1 for w in self.class_weights
            ):
                raise ValueError(
                    f"class_weights must be k_classes={k_classes} ints >= 1, "
                    f"got {class_weights}"
                )
        else:
            if class_weights is not None:
                raise ValueError("class_weights needs k_classes >= 2")
            self.k_classes = 0
            self.class_weights = []
        self._class_cursor = 0
        # (sid, class) per admission, in admission order, and (admissions
        # before it, sid, class) per accepted arrival: the starvation
        # bound's witness (k-class tiers only; ``starvation_gap``)
        self.admit_log: List[Tuple[int, int]] = []
        self.arrival_log: List[Tuple[int, int, int]] = []
        if slots > SESSION_SLOT_NONE:
            raise ValueError(
                f"slots={slots} exceeds the packed slot field "
                f"(max {SESSION_SLOT_NONE}: id {SESSION_SLOT_NONE} is the "
                f"unbound sentinel)"
            )
        req_kind = "deque" if priority else "queue"
        kinds = [req_kind] * n_queues + ["stack", "map"]
        n_shards = n_queues + 2
        n_buckets = n_buckets or 4 * n_shards
        self.n_queues = n_queues
        self.pool_shard = n_queues
        self.session_shard = n_queues + 1
        self.priority = priority
        if durable and fs is None:
            fs = SimFS(Path(tempfile.mkdtemp(prefix="dfc_serve_tier_")))
        self.durable = durable
        self.split_lanes = split_lanes
        # ``_rt`` lets ``recover`` mount an already-recovered fabric
        self.rt = _rt if _rt is not None else ShardedDFCRuntime(
            kinds, n_shards, capacity, lanes,
            fs=fs if durable else None, n_threads=1,
            n_buckets=n_buckets,
            table=self._default_table(
                n_queues, n_buckets, k_classes=bool(self.k_classes)
            ),
            pipeline=pipeline, depth=depth, split_lanes=split_lanes, obs=obs,
            device=device,
        )
        # the tier and the fabric share ONE observer: request lifecycle
        # events land in the durable path's timeline, latency histograms in
        # the registry that holds the per-shard gauges
        self.obs = obs if obs is not None else self.rt.obs
        self._arrival_t: Dict[int, float] = {}  # sid -> arrival perf_counter
        self._admit_t: Dict[int, float] = {}  # sid -> admission perf_counter
        self.reshard_backlog = reshard_backlog
        self._rep_keys: Dict[int, int] = {}
        self._smap_keys: Dict[int, int] = {}  # sid -> session-state map key
        self._sprog_keys: Dict[int, int] = {}  # sid -> decode-progress map key
        self._slot_retry: List[int] = []  # pool pushes that overflowed a phase
        # session-state writes that overflowed the map shard's lanes, retried
        # on the next submit: (sid, packed) pairs
        self._state_retry: List[Tuple[int, int]] = []
        # host mirrors of the session map (rebuilt from the fabric walk on
        # recovery): caches, never the source of truth
        self._session_prio: Dict[int, int] = {}
        self._session_slot: Dict[int, int] = {}
        self._token = 0
        self.stats = {"arrived": 0, "admitted": 0, "rejected": 0, "splits": 0}
        if _seed_slots:
            # seed the slot pool (submit chunks pushes to the pool's lanes)
            self.submit([], release_slots=list(range(slots)))
            while self._slot_retry:
                self.submit([])

    # ------------------------------------------------------------ internals
    @staticmethod
    def _default_table(
        n_queues: int, n_buckets: int, k_classes: bool = False
    ) -> np.ndarray:
        """Bucket 0 -> pool stack (shard ``n_queues``); every fourth bucket
        after it -> session map (shard ``n_queues + 1``); the rest
        round-robin over the request shards.  k-class tiers round-robin over
        the surviving buckets instead of ``b % n_queues``, so no class shard
        loses all its buckets to the session map."""
        pool, smap = n_queues, n_queues + 1
        if not k_classes:
            return np.asarray(
                [pool]
                + [smap if b % 4 == 1 else b % n_queues for b in range(1, n_buckets)],
                np.int32,
            )
        out, nxt = [pool], 0
        for b in range(1, n_buckets):
            if b % 4 == 1:
                out.append(smap)
            else:
                out.append(nxt % n_queues)
                nxt += 1
        return np.asarray(out, np.int32)

    def _key_for(self, shard: int) -> int:
        if shard not in self._rep_keys:
            self._rep_keys[shard] = self.rt.key_for_shard(shard)
        return self._rep_keys[shard]

    def _phase(self, keys, ops, params) -> Tuple[np.ndarray, np.ndarray]:
        """One tier phase: fused volatile step, or announce + combine + read
        through the fabric's announcement ring.  The tier needs each phase's
        responses at once (admission decisions), so it flushes any in-flight
        chains right after dispatch."""
        if not self.durable:
            resp, kinds = self.rt.step(keys, ops, params)
            return _to_np(resp), _to_np(kinds)
        self._token += 1
        self.rt.announce(0, keys, ops, params, token=self._token)
        self.rt.combine_phase()
        self.rt.flush()
        val = self.rt.read_responses(0, token=self._token)
        return np.asarray(val["resp"]), np.asarray(val["kinds"])

    def session_key(self, sid: int) -> int:
        """Deterministic key for a session id, re-probed off the pool and
        session-map shards."""
        if not 0 <= sid < (1 << 24):
            # sids round-trip through the fabric's float32 values
            raise ValueError(f"session id {sid} must be in [0, 2^24)")
        k = int(sid)
        while int(self.rt.route_host([k])[0]) in (self.pool_shard, self.session_shard):
            k = (k * _HASH_MULT + 1) % (1 << 31)
        return k

    def _session_window_keys(self, sid: int, need: int = 2) -> List[int]:
        """The first ``need`` keys of ``sid``'s private window that route to
        the session shard."""
        base = int(sid) * _SESSION_KEY_STRIDE
        cand = np.arange(base, base + _SESSION_KEY_STRIDE, dtype=np.int64)
        hit = np.nonzero(self.rt.route_host(cand) == self.session_shard)[0]
        if hit.size < need:
            raise RuntimeError(
                f"only {hit.size} keys in window [{base}, "
                f"{base + _SESSION_KEY_STRIDE}) route to the session map "
                f"shard (need {need}); widen its bucket share"
            )
        return [int(cand[h]) for h in hit[:need]]

    def session_map_key(self, sid: int) -> int:
        """Fabric key of ``sid``'s session-STATE map entry."""
        if sid not in self._smap_keys:
            self._smap_keys[sid] = self._session_window_keys(sid)[0]
        return self._smap_keys[sid]

    def session_progress_key(self, sid: int) -> int:
        """Fabric key of ``sid``'s decode-PROGRESS map entry."""
        if sid not in self._sprog_keys:
            self._sprog_keys[sid] = self._session_window_keys(sid)[1]
        return self._sprog_keys[sid]

    def _smap_write_key(self, sid: int, packed: int) -> int:
        if packed >= PROGRESS_TAG:
            return self.session_progress_key(sid)
        return self.session_map_key(sid)

    def _stage_session_writes(
        self, sids: Sequence[int], cls_list: Sequence[int]
    ) -> List[Tuple[int, int]]:
        """Arrival-time session-state map inserts (plus retries), capped at
        the map shard's per-phase lanes.  Retried arrivals whose session
        already advanced past QUEUED are dropped instead of regressing it;
        retried PROGRESS entries always pass through."""
        writes = [
            (sid, packed)
            for sid, packed in self._state_retry
            if packed >= PROGRESS_TAG
            or unpack_session(packed)["stage"] != SESSION_QUEUED
            or sid not in self._session_slot
        ]
        for s, c in zip(sids, cls_list):
            self._session_prio[int(s)] = int(c)
            writes.append((int(s), pack_session(int(c), SESSION_SLOT_NONE, SESSION_QUEUED)))
        self._state_retry = writes[self.rt.lanes:]
        return writes[: self.rt.lanes]

    def _arrival_classes(
        self,
        sids: Sequence[int],
        priorities: Optional[Sequence[int]],
        classes: Optional[Sequence[int]],
    ) -> List[int]:
        """Per-arrival class labels: FIFO -> all zero, binary priority ->
        0/1 from ``priorities``, k-class -> ``classes`` in [0, k)."""
        if priorities is not None and not self.priority:
            raise ValueError("priorities given but tier built without priority=True")
        if priorities is not None and len(priorities) != len(sids):
            raise ValueError(
                f"priorities ({len(priorities)}) must parallel sids ({len(sids)})"
            )
        if classes is not None and not self.k_classes:
            raise ValueError("classes given but tier built without k_classes")
        if self.k_classes:
            cls = list(classes) if classes is not None else [0] * len(sids)
            if len(cls) != len(sids):
                raise ValueError(f"classes ({len(cls)}) must parallel sids ({len(sids)})")
            for c in cls:
                if not 0 <= int(c) < self.k_classes:
                    raise ValueError(f"class {c} outside [0, {self.k_classes})")
            return [int(c) for c in cls]
        if self.priority:
            pr = list(priorities) if priorities is not None else [0] * len(sids)
            return [1 if p > 0 else 0 for p in pr]
        return [0] * len(sids)

    def _queue_backlogs(self) -> Dict[int, int]:
        """Committed backlog per request shard, from the fabric's active
        root counters."""
        sizes = self.rt.shard_sizes()
        return {
            s: int(sizes[s])
            for s in range(self.rt.n_shards)
            if self.rt.kinds[s] in ("queue", "deque")
        }

    def _stage_arrivals(self, sids, release_slots, cls_list):
        """Keys, ops and params of one arrival round: request enqueues,
        pool pushes (retries first, capped at the lanes), session writes."""
        pool = self._slot_retry + list(release_slots)
        self._slot_retry = pool[self.rt.lanes:]
        pool = pool[: self.rt.lanes]
        smap = self._stage_session_writes(sids, cls_list)
        if self.k_classes:
            keys = [self._key_for(c) for c in cls_list]  # shard c == class c
        else:
            keys = [self.session_key(s) for s in sids]
        keys += [self._key_for(self.pool_shard)] * len(pool)
        keys += [self._smap_write_key(sid, v) for sid, v in smap]
        if self.priority:
            enq_ops = [OP_PUSH_FRONT if c > 0 else OP_PUSH_BACK for c in cls_list]
        else:
            enq_ops = [OP_ENQ] * len(sids)
        ops = enq_ops + [OP_PUSH] * len(pool) + [OP_MAP_INSERT] * len(smap)
        params = [float(s) for s in sids] + [float(s) for s in pool]
        params += [float(v) for _, v in smap]
        return pool, smap, keys, ops, params

    def _settle_arrivals(self, sids, pool, smap, kinds, cls_list) -> List[int]:
        """Queue the round's overflowed pool pushes and session writes for
        retry, count it, log its accepted arrivals, and return its rejected
        session ids."""
        rejected = [s for i, s in enumerate(sids) if kinds[i] == R_OVERFLOW]
        if self.k_classes:
            self.arrival_log += [(len(self.admit_log), int(s), int(c))
                                 for i, (s, c) in enumerate(zip(sids, cls_list))
                                 if kinds[i] != R_OVERFLOW]
        for j, slot in enumerate(pool):
            if kinds[len(sids) + j] == R_OVERFLOW:
                self._slot_retry.append(slot)
        off = len(sids) + len(pool)
        for j, (sid, packed) in enumerate(smap):
            if kinds[off + j] == R_OVERFLOW:
                self._state_retry.append((sid, packed))
        self.stats["arrived"] += len(sids)
        self.stats["rejected"] += len(rejected)
        return rejected

    # ------------------------------------------------------------- tier API
    def submit(
        self,
        sids: Sequence[int],
        release_slots: Sequence[int] = (),
        priorities: Optional[Sequence[int]] = None,
        classes: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Enqueue arriving sessions and return freed decode slots to the
        pool in one mixed-kind combined phase.  Returns session ids that
        overflowed their shard's lanes (re-submit next round).  Pool pushes
        past the lanes, or rejected with R_OVERFLOW, are retried on the next
        submit, so a decode slot never leaks."""
        cls_list = self._arrival_classes(sids, priorities, classes)
        pool, smap, keys, ops, params = self._stage_arrivals(sids, release_slots, cls_list)
        if not ops:
            return []
        self._stamp_arrivals(sids)
        _, kinds = self._phase(keys, ops, params)
        rejected = self._settle_arrivals(sids, pool, smap, kinds, cls_list)
        if self.obs.enabled and sids:
            self.obs.event("request", stage="arrive", sids=[int(s) for s in sids],
                           rejected=[int(s) for s in rejected])
        self._maybe_split()
        return rejected

    def _stamp_arrivals(self, sids) -> None:
        """First-arrival timestamps (they survive overflow retries)."""
        now = time.perf_counter()
        for s in sids:
            self._arrival_t.setdefault(int(s), now)

    def submit_waves(
        self,
        waves: Sequence[Tuple[Sequence[int], Sequence[int], Optional[Sequence[int]]]],
    ) -> List[List[int]]:
        """Commit many submit rounds in ONE fused device dispatch: the tier
        riding the fabric's K-phase ``phase_loop``.  ``waves`` holds
        ``(sids, release_slots, priorities[, classes])`` rounds; each
        becomes one combining phase with the same durable schedule and
        pwb/pfence counts as that many ``submit`` calls.  Volatile tiers run
        one ``step`` per wave.  Returns the per-wave rejected session ids.
        Slot-pool retries found by wave j are re-pushed by the NEXT
        ``submit``/``submit_waves`` call."""
        staged = []
        for wave in waves:
            sids, release_slots, priorities = wave[0], wave[1], wave[2]
            classes = wave[3] if len(wave) > 3 else None
            cls_list = self._arrival_classes(sids, priorities, classes)
            staged.append((list(sids), *self._stage_arrivals(sids, release_slots, cls_list),
                           cls_list))
            self._stamp_arrivals(sids)

        rejected_per_wave: List[List[int]] = [[] for _ in staged]
        live = [i for i, st in enumerate(staged) if st[4]]
        if live:
            if self.durable:
                schedule = []
                for i in live:
                    keys, ops, params = staged[i][3:6]
                    self._token += 1
                    schedule.append((0, self._token, keys, ops, params))
                records = self.rt.phase_loop(schedule)
                kinds_per_wave = [np.asarray(r["kinds"]) for r in records]
            else:
                kinds_per_wave = []
                for i in live:
                    keys, ops, params = staged[i][3:6]
                    _, kinds = self.rt.step(keys, ops, params)
                    kinds_per_wave.append(_to_np(kinds))
            for i, kinds in zip(live, kinds_per_wave):
                sids, pool, smap = staged[i][:3]
                rejected_per_wave[i] = self._settle_arrivals(sids, pool, smap, kinds,
                                                             staged[i][6])
                if self.obs.enabled and sids:
                    self.obs.event("request", stage="arrive", wave=i,
                                   sids=[int(s) for s in sids],
                                   rejected=[int(s) for s in rejected_per_wave[i]])
        self._maybe_split()
        return rejected_per_wave

    def admit(self, max_n: int) -> List[Tuple[int, int]]:
        """Admit up to ``max_n`` sessions: pop free slots from the pool
        stack, then dequeue that many sessions from the backlogged request
        shards (round-robin; weighted round-robin across the class shards
        on k-class tiers).  Returns ``[(session_id, slot), ...]``."""
        if max_n <= 0:
            return []
        pool_key = self._key_for(self.pool_shard)
        resp, kinds = self._phase([pool_key] * max_n, [OP_POP] * max_n, [0.0] * max_n)
        slots = [int(resp[i]) for i in range(max_n) if kinds[i] == R_VALUE]
        if not slots:
            return []
        deqs: List[Tuple[int, int]] = []  # (shard, representative key)
        budget = self._queue_backlogs()
        if self.k_classes:
            plan, self._class_cursor = weighted_dequeue_plan(
                [budget.get(c, 0) for c in range(self.k_classes)],
                self.class_weights,
                len(slots),
                self._class_cursor,
            )
            deqs = [(c, self._key_for(c)) for c in plan]
        else:
            while len(deqs) < len(slots):
                ready = [s for s, n in sorted(budget.items()) if n > 0]
                if not ready:
                    break
                for s in ready:
                    if len(deqs) >= len(slots):
                        break
                    deqs.append((s, self._key_for(s)))
                    budget[s] -= 1
        if not deqs:
            self.submit([], release_slots=slots)  # nothing queued: put back
            return []
        deq_op = OP_POP_FRONT if self.priority else OP_DEQ
        resp, kinds = self._phase(
            [k for _, k in deqs], [deq_op] * len(deqs), [0.0] * len(deqs)
        )
        admitted: List[Tuple[int, int]] = []
        spare = deque(slots)
        for i, (shard, _) in enumerate(deqs):
            if kinds[i] == R_VALUE:
                admitted.append((int(resp[i]), spare.popleft()))
                if self.k_classes:
                    self.admit_log.append((int(resp[i]), shard))
        if spare:
            self.submit([], release_slots=list(spare))
        self._bind_sessions(admitted)
        self.stats["admitted"] += len(admitted)
        if self.obs.enabled and admitted:
            now = time.perf_counter()
            for sid, _ in admitted:
                t_arr = self._arrival_t.get(sid)
                self._admit_t[sid] = now
                if t_arr is not None:
                    self.obs.metrics.observe("admission_ms", (now - t_arr) * 1e3)
            self.obs.event("request", stage="admit",
                           pairs=[[int(s), int(sl)] for s, sl in admitted])
        return admitted

    def _bind_sessions(self, pairs: List[Tuple[int, int]]) -> None:
        """Bind decode slots at admission: QUEUED -> ADMITTED via fabric CAS
        on the session map; a CAS that loses, or a missing entry, falls back
        to one plain insert of the new state."""
        if not pairs:
            return
        expect = {}
        for sid, slot in pairs:
            self._session_slot[sid] = slot
            expect[sid] = pack_session(
                self._session_prio.get(sid, 0), SESSION_SLOT_NONE, SESSION_QUEUED
            )
        keys = [self.session_map_key(sid) for sid, _ in pairs]
        params = [
            pack_cas(expect[sid],
                     pack_session(self._session_prio.get(sid, 0), slot, SESSION_ADMITTED))
            for sid, slot in pairs
        ]
        resp, kinds = self._phase(keys, [OP_MAP_CAS] * len(pairs), params)
        fallback = []
        for j, (sid, slot) in enumerate(pairs):
            if kinds[j] == R_CAS_FAIL:
                self._session_prio[sid] = unpack_session(resp[j])["priority"]
                fallback.append((sid, slot))
            elif kinds[j] != R_VALUE:  # R_EMPTY / R_OVERFLOW
                fallback.append((sid, slot))
        if fallback:
            keys = [self.session_map_key(sid) for sid, _ in fallback]
            packs = [
                pack_session(self._session_prio.get(sid, 0), slot, SESSION_ADMITTED)
                for sid, slot in fallback
            ]
            _, kinds = self._phase(
                keys, [OP_MAP_INSERT] * len(fallback), [float(p) for p in packs]
            )
            for j, (sid, _) in enumerate(fallback):
                if kinds[j] == R_OVERFLOW:
                    self._state_retry.append((sid, packs[j]))

    def session_state(self, sid: int) -> Optional[Dict[str, int]]:
        """One session's committed state read THROUGH the fabric (a combined
        ``OP_MAP_LOOKUP``), or ``None`` when it has no entry."""
        resp, kinds = self._phase([self.session_map_key(sid)], [OP_MAP_LOOKUP], [0.0])
        if kinds[0] == R_VALUE:
            return unpack_session(resp[0])
        return None

    def session_states(self) -> Dict[int, Dict[str, int]]:
        """Committed session-state table from one walk of the session map
        shard: ``{sid: {"cls", "priority", "slot", "stage"}}``."""
        return {
            int(k) // _SESSION_KEY_STRIDE: unpack_session(v)
            for k, v in self.rt.shard_contents(self.session_shard)
            if int(v) < PROGRESS_TAG
        }

    def session_progress_table(self) -> Dict[int, int]:
        """Committed decode progress per session, from the same walk."""
        return {
            int(k) // _SESSION_KEY_STRIDE: int(v) - PROGRESS_TAG
            for k, v in self.rt.shard_contents(self.session_shard)
            if int(v) >= PROGRESS_TAG
        }

    def record_progress(self, progress: Mapping[int, int]) -> None:
        """Commit per-session decode progress in ONE combined phase (tagged
        inserts at each session's progress key; overflow is retried)."""
        items = [(int(sid), int(tok)) for sid, tok in sorted(progress.items())]
        for sid, tok in items:
            if not 0 <= tok < PROGRESS_MAX:
                raise ValueError(
                    f"progress {tok} for session {sid} outside [0, {PROGRESS_MAX})"
                )
        writes = [(sid, PROGRESS_TAG + tok) for sid, tok in items]
        overflow, writes = writes[self.rt.lanes:], writes[: self.rt.lanes]
        self._state_retry.extend(overflow)
        if not writes:
            return
        keys = [self.session_progress_key(sid) for sid, _ in writes]
        _, kinds = self._phase(
            keys, [OP_MAP_INSERT] * len(writes), [float(v) for _, v in writes]
        )
        for j, (sid, v) in enumerate(writes):
            if kinds[j] == R_OVERFLOW:
                self._state_retry.append((sid, v))

    def starvation_bound(self) -> int:
        """Max number of other-class admissions between two consecutive
        admissions of the backlogged lowest class: ``sum(w) - w[0]``."""
        if not self.k_classes:
            raise ValueError("starvation_bound needs a k_classes tier")
        return sum(self.class_weights) - self.class_weights[0]

    def starvation_gap(self) -> int:
        """The longest run of other-class admissions while class 0 had a
        session queued (accepted and not yet admitted), from ``admit_log``
        and ``arrival_log``: what ``starvation_bound()`` bounds."""
        if not self.k_classes:
            raise ValueError("starvation_gap needs a k_classes tier")
        arrivals = iter(self.arrival_log)
        nxt = next(arrivals, None)
        queued, gap, worst = 0, 0, 0
        for i, (_, cls) in enumerate(self.admit_log):
            while nxt is not None and nxt[0] <= i:
                queued += nxt[2] == 0
                nxt = next(arrivals, None)
            if cls == 0:
                queued, gap = queued - 1, 0
            elif queued:
                gap += 1
                worst = max(worst, gap)
        return worst

    def backlog(self) -> int:
        return sum(self._queue_backlogs().values())

    def queued_sessions(self) -> List[int]:
        """Session ids committed in the request shards, front first per
        shard: what a resumed launcher reconciles against."""
        out: List[int] = []
        for s in range(self.rt.n_shards):
            if self.rt.kinds[s] in ("queue", "deque"):
                out.extend(int(v) for v in self.rt.shard_contents(s))
        return out

    def pool_slots(self) -> List[int]:
        """Free decode slots committed in the pool stack."""
        return [int(v) for v in self.rt.shard_contents(self.pool_shard)]

    def _maybe_split(self) -> None:
        """Split the hottest request shard once its backlog reaches
        ``reshard_backlog`` (crash-consistent; the new shard takes half of
        its buckets)."""
        if self.reshard_backlog is None:
            return
        backlogs = self._queue_backlogs()
        hot = max(backlogs, key=backlogs.get)
        if backlogs[hot] < self.reshard_backlog:
            return
        try:
            self.rt.split_shard(hot)
        except ValueError:
            return  # no spare bucket left on this shard
        self._rep_keys.clear()  # the table changed: representative keys are stale
        self._smap_keys.clear()
        self._sprog_keys.clear()
        self.stats["splits"] += 1

    def persistence_stats(self) -> Optional[Dict[str, float]]:
        if not self.durable:
            return None
        ops = max(self.stats["arrived"] + self.stats["admitted"], 1)
        return {
            "pwb_per_op": self.rt.fs.stats["pwb"] / ops,
            "pfence_per_op": self.rt.fs.stats["pfence"] / ops,
        }

    def mark_served(self, sid: int) -> None:
        """Advance the session's map entry to SERVED through the fabric,
        keeping its slot binding.  Observed tiers also record the service
        (admit -> served) and end-to-end (arrive -> served) latencies and
        the request's last event."""
        packed = pack_session(
            self._session_prio.get(sid, 0),
            self._session_slot.get(sid, SESSION_SLOT_NONE),
            SESSION_SERVED,
        )
        _, kinds = self._phase([self.session_map_key(sid)], [OP_MAP_INSERT], [float(packed)])
        if kinds[0] == R_OVERFLOW:
            self._state_retry.append((sid, packed))
        if not self.obs.enabled:
            return
        now = time.perf_counter()
        t_adm = self._admit_t.pop(sid, None)
        t_arr = self._arrival_t.pop(sid, None)
        if t_adm is not None:
            self.obs.metrics.observe("service_ms", (now - t_adm) * 1e3)
        if t_arr is not None:
            self.obs.metrics.observe("e2e_ms", (now - t_arr) * 1e3)
        self.obs.event("request", stage="served", sid=int(sid))

    def latency_stats(self) -> Optional[Dict[str, Dict[str, float]]]:
        """count / mean / min / max / p50 / p99 of each latency histogram
        (``admission_ms``, and ``service_ms`` / ``e2e_ms`` once
        ``mark_served`` ran); None when the tier runs unobserved."""
        if not self.obs.enabled:
            return None
        return {
            name: h.summary()
            for name, h in sorted(self.obs.metrics.histograms.items())
            if name.endswith("_ms")
        }

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(
        cls,
        fs: SimFS,
        *,
        n_queues: int = 4,
        capacity: int = 4096,
        lanes: int = 64,
        n_buckets: Optional[int] = None,
        priority: bool = False,
        k_classes: int = 0,
        class_weights: Optional[Sequence[int]] = None,
        reshard_backlog: Optional[int] = None,
        pipeline: bool = False,
        depth: Optional[int] = None,
        split_lanes: bool = False,
        obs=None,
        device="cuda",
    ) -> Tuple["RequestQueueTier", Dict[str, Any]]:
        """Recover a durable tier after a crash.  Returns ``(tier, info)``,
        ``info`` holding what a resuming launcher reconciles:

          * ``"report"``: the raw per-thread detectability report;
          * ``"queued"``: session ids still committed in the request shards;
          * ``"pool"``: free slot ids committed in the pool stack;
          * ``"in_flight"``: sessions whose DEQUEUE committed (they left the
            queue) but whose service the launcher may not have recorded;
          * ``"lost_arrivals"``: sessions whose ENQUEUE was announced but
            reported not-applied: resubmit them;
          * ``"sessions"`` / ``"progress"``: the committed session-state and
            decode-progress tables, from one walk of the session map;
          * ``"session_reads"``: committed ``OP_MAP_LOOKUP`` results, read
            from the durable response slot, never re-executed.

        The tier does not blanket-``replay_pending``: replaying a
        not-applied dequeue would admit a session nobody waits on.  The
        fabric's durable routing record, when the tier split before the
        crash, overrides the bootstrap shape."""
        req_kind = "deque" if priority else "queue"
        if k_classes and k_classes >= 2:
            n_queues = k_classes  # shard c == class c, as in __init__
        n_shards = n_queues + 2
        n_buckets = n_buckets or 4 * n_shards
        rt, report = ShardedDFCRuntime.recover(
            fs,
            kind=[req_kind] * n_queues + ["stack", "map"],
            n_shards=n_shards,
            capacity=capacity,
            lanes=lanes,
            n_threads=1,
            n_buckets=n_buckets,
            table=cls._default_table(
                n_queues, n_buckets, k_classes=bool(k_classes and k_classes >= 2)
            ),
            pipeline=pipeline,
            depth=depth,
            split_lanes=split_lanes,
            obs=obs,
            device=device,
        )
        tier = cls(
            n_queues=n_queues, slots=0, capacity=capacity, lanes=lanes,
            durable=True, fs=fs, reshard_backlog=reshard_backlog, n_buckets=n_buckets,
            pipeline=pipeline, depth=depth, priority=priority, k_classes=k_classes,
            class_weights=class_weights, split_lanes=rt.split_lanes, obs=obs,
            device=device, _seed_slots=False, _rt=rt,
        )
        tier.n_queues = sum(1 for k in rt.kinds if k in ("queue", "deque"))
        tier.pool_shard = next(s for s, k in enumerate(rt.kinds) if k == "stack")
        tier.session_shard = next(s for s, k in enumerate(rt.kinds) if k == "map")
        # ONE walk of the session shard restores the per-session serving
        # state and reseeds the host mirrors the admission CAS consults
        sessions = tier.session_states()
        progress = tier.session_progress_table()
        for sid, st in sessions.items():
            tier._session_prio[sid] = st["cls"]
            if st["slot"] != SESSION_SLOT_NONE:
                tier._session_slot[sid] = st["slot"]
        in_flight: List[int] = []
        lost_arrivals: List[int] = []
        session_reads: Dict[int, Dict[str, int]] = {}
        max_token = 0
        r = report.get(0) or {"token": None, "ops": [], "prev": None}
        recs = ([dict(r, slot="newest")] if r["token"] is not None else []) + (
            [dict(r["prev"], slot="prev")] if r.get("prev") else []
        )
        for rec in recs:
            max_token = max(max_token, rec["token"])
            lsb = rt._read_valid(0) & 1
            ann = rt._read_ann(0, lsb if rec["slot"] == "newest" else 1 - lsb)
            if ann.get("token", -1) != rec["token"]:
                continue
            for i, v in enumerate(rec["ops"]):
                op = ann["ops"][i]
                shard = (
                    v.shard
                    if v.shard is not None
                    else int(rt.route_host([ann["keys"][i]])[0])
                )
                on_request = rt.kinds[shard] in ("queue", "deque")
                if v.applied and on_request and op in (OP_DEQ, OP_POP_FRONT):
                    in_flight.append(int(v.resp))
                if (not v.applied and op in (OP_ENQ, OP_PUSH_BACK, OP_PUSH_FRONT)
                        and on_request):
                    lost_arrivals.append(int(ann["params"][i]))
                # a committed lookup's read value comes from the durable
                # response slot, never from re-executing it
                if (
                    v.applied
                    and rt.kinds[shard] == "map"
                    and op == OP_MAP_LOOKUP
                    and v.kind == R_VALUE
                    and int(v.resp) < PROGRESS_TAG
                ):
                    sid = int(ann["keys"][i]) // _SESSION_KEY_STRIDE
                    session_reads[sid] = unpack_session(int(v.resp))
        tier._token = max_token
        info = {
            "report": report,
            "queued": tier.queued_sessions(),
            "pool": tier.pool_slots(),
            "in_flight": sorted(set(in_flight)),
            "lost_arrivals": sorted(set(lost_arrivals)),
            "sessions": sessions,
            "progress": progress,
            "session_reads": session_reads,
        }
        return tier, info


# ---------------------------------------------------------------- launcher
def _served_log_path(state_dir: Path) -> Path:
    return state_dir / "served.log"


def _read_served(state_dir: Path) -> List[int]:
    p = _served_log_path(state_dir)
    if not p.exists():
        return []
    return [int(x) for x in p.read_text().split()]


def _log_served(state_dir: Optional[Path], sid: int) -> None:
    """The downstream consumer's durable record of a completed session: a
    plain append-only file OUTSIDE the fault-injected SimFS (the demo
    crashes the tier, not the consumer)."""
    if state_dir is None:
        return
    with _served_log_path(state_dir).open("a") as f:
        f.write(f"{sid}\n")
        f.flush()


def _tokens_log_path(state_dir: Path) -> Path:
    return state_dir / "tokens.log"


def _read_token_entries(state_dir: Optional[Path]) -> Dict[int, List[Tuple[int, int]]]:
    """The consumer's raw token log: ``{sid: [(idx, token), ...]}`` in file
    order (the exactly-once audit reads it unfiltered)."""
    if state_dir is None:
        return {}
    p = _tokens_log_path(state_dir)
    if not p.exists():
        return {}
    out: Dict[int, List[Tuple[int, int]]] = {}
    for line in p.read_text().splitlines():
        if not line.strip():
            continue
        sid, idx, tok = (int(x) for x in line.split())
        out.setdefault(sid, []).append((idx, tok))
    return out


def _committed_tokens(entries: Sequence[Tuple[int, int]]) -> List[int]:
    """The contiguous committed token prefix of one session's raw log
    entries (the first write of an index wins): what a resumed decode
    continues from."""
    by_idx: Dict[int, int] = {}
    for idx, tok in entries:
        by_idx.setdefault(idx, tok)
    toks: List[int] = []
    while len(toks) in by_idx:
        toks.append(by_idx[len(toks)])
    return toks


def _log_tokens(state_dir: Optional[Path], sid: int, start: int, toks: Sequence[int]) -> None:
    """The consumer's durable record of emitted decode tokens: the same
    append-only contract as ``served.log`` (outside the fault-injected
    SimFS, flushed per call)."""
    if state_dir is None or not toks:
        return
    with _tokens_log_path(state_dir).open("a") as f:
        for j, t in enumerate(toks):
            f.write(f"{sid} {start + j} {int(t)}\n")
        f.flush()


def verify_exactly_once(
    sids: Sequence[int],
    gen: int,
    served: Sequence[int],
    token_entries: Mapping[int, Sequence[Tuple[int, int]]],
) -> None:
    """Audit the consumer logs after a (possibly crashed and resumed) run:
    every session served exactly once, and every token index ``0..gen-1``
    of every session emitted exactly once."""
    expect = sorted(int(s) for s in sids)
    got = sorted(int(s) for s in served)
    assert got == expect and len(served) == len(set(served)), (
        f"exactly-once violated: served={got} expected={expect}"
    )
    for s in expect:
        idxs = sorted(i for i, _ in token_entries.get(s, []))
        assert idxs == list(range(gen)), (
            f"token exactly-once violated for session {s}: "
            f"indices {idxs} != 0..{gen - 1}"
        )


class ContinuousServer:
    """Continuous-batching decode loop in which every scheduling decision is
    a fabric op: arrivals enqueue into the k class shards (``submit``),
    admission rides the weighted multi-shard dequeue (``admit``), decode
    slots come from and go back to the slot-pool stack shard, each round's
    per-session token counts commit to the session map in one phase
    (``record_progress``), and retirement is a fabric op (``mark_served``).

    Each round every active session decodes one QUANTUM of tokens (the
    ``decode`` callable: ``make_model_decode`` on the model path, the
    deterministic ``sim_token`` decoder otherwise), the tokens go to the
    consumer's token log, then progress commits; finished sessions retire
    and their slots return through the fabric, so admissions join
    mid-stream as slots free.

    Crash-exact resume: the consumer logs (``served.log`` / ``tokens.log``)
    live outside the fault-injected SimFS.  A resumed server rebuilds the
    in-flight sessions from the recovery walk (committed dequeues in the
    announcement slots, plus map entries at ADMITTED or SERVED), drops what
    the served log holds, restarts each at its committed token offset and
    emits exactly the remaining tokens; ``verify_exactly_once`` audits the
    logs.
    """

    def __init__(
        self,
        tier: RequestQueueTier,
        *,
        sids: Sequence[int],
        batch: int,
        gen: int,
        quantum: int = 0,
        arrival: int = 0,
        class_of: Optional[Callable[[int], int]] = None,
        state_dir: Optional[Path] = None,
        decode: Optional[Callable[..., List[int]]] = None,
        resume_info: Optional[Dict[str, Any]] = None,
        served_before: Sequence[int] = (),
        token_log: Optional[Mapping[int, Sequence[int]]] = None,
    ):
        self.tier = tier
        self.sids = [int(s) for s in sids]
        self.batch = int(batch)
        self.gen = int(gen)
        self.quantum = int(quantum) or self.gen
        self.arrival = int(arrival) or self.batch
        k = tier.k_classes
        self.class_of = class_of or ((lambda sid: sid % k) if k else (lambda sid: 0))
        self.state_dir = state_dir
        self.decode = decode or self._sim_decode
        self.served: List[int] = [int(s) for s in served_before]
        # committed token prefix per session (mirrors the consumer log)
        self.token_log: Dict[int, List[int]] = {
            int(s): list(t) for s, t in (token_log or {}).items()
        }
        # sid -> {"slot", "done", "state"}; "state" is the decoder's scratch
        # (the model path keeps the session's KV cache there)
        self.active: Dict[int, Dict[str, Any]] = {}
        self.rounds = 0
        self.decoded = 0
        self.pending = (
            self._reconcile(resume_info) if resume_info is not None else list(self.sids)
        )

    @staticmethod
    def sim_token(sid: int, idx: int) -> int:
        """The simulated decoder's token: deterministic, so the tier-only path
        and the crash sweeps check token-level exactly-once without a model."""
        return (int(sid) * 1009 + int(idx) * 31) % 4093

    def _sim_decode(self, sid, start, n, state, history):
        return [self.sim_token(sid, start + j) for j in range(n)]

    def _reconcile(self, info: Dict[str, Any]) -> List[int]:
        """Rebuild the serving state from one recovery walk: in-flight
        sessions resume mid-decode on their bound slots, queued sessions
        stay queued, everything else resubmits; the slot pool is restored
        to exactly ``batch`` minus free minus held.  Returns the sessions to
        submit."""
        served_set = set(self.served)
        sessions = info["sessions"]
        universe = set(self.sids)
        # committed dequeues of the announcement slots, plus map entries at
        # ADMITTED (admitted long ago: the dequeue's record was overwritten)
        # or at SERVED without a served-log line (its tokens are logged
        # first, so it retires without decoding again); the served log wins
        in_flight = sorted(
            (set(info["in_flight"])
             | {s for s, st in sessions.items()
                if st["stage"] in (SESSION_ADMITTED, SESSION_SERVED)})
            & universe - served_set
        )
        queued = set(info["queued"])
        pending = [
            s for s in self.sids
            if s not in served_set and s not in queued and s not in in_flight
        ]
        pool = set(info["pool"])
        complement = [i for i in range(self.batch) if i not in pool]
        assert len(complement) >= len(in_flight), (complement, in_flight)
        taken: set = set()
        for sid in in_flight:
            st = sessions.get(sid)
            slot = st["slot"] if st is not None else SESSION_SLOT_NONE
            if (slot == SESSION_SLOT_NONE or slot >= self.batch
                    or slot in pool or slot in taken):
                slot = next(i for i in complement if i not in taken)
            taken.add(slot)
            done = min(len(self.token_log.get(sid, ())), self.gen)
            self.active[sid] = {"slot": slot, "done": done, "state": {}}
        # complement slots that no in-flight session holds go back to the pool
        leftovers = [i for i in complement if i not in taken]
        if leftovers:
            self.tier.submit([], release_slots=leftovers)
        return pending

    def _outstanding(self) -> List[int]:
        done = set(self.served)
        return [s for s in self.sids if s not in done]

    def run(self, max_rounds: Optional[int] = None) -> Dict[str, Any]:
        tier = self.tier
        waiting: List[int] = []
        next_idx = 0
        limit = max_rounds or (8 * max(len(self.sids), 1) + 64)
        for _ in range(limit):
            if not self._outstanding():
                break
            self.rounds += 1
            fresh = self.pending[next_idx : next_idx + self.arrival]
            next_idx += len(fresh)
            subs = waiting + fresh
            if subs:
                kw: Dict[str, Any] = {}
                if tier.k_classes:
                    kw["classes"] = [self.class_of(s) for s in subs]
                elif tier.priority:
                    kw["priorities"] = [self.class_of(s) for s in subs]
                waiting = tier.submit(subs, **kw)
            for sid, slot in tier.admit(self.batch - len(self.active)):
                self.active[sid] = {"slot": slot, "done": 0, "state": {}}
            progress: Dict[int, int] = {}
            finished: List[int] = []
            for sid, st in sorted(self.active.items()):
                n_new = min(self.quantum, self.gen - st["done"])
                history = self.token_log.setdefault(sid, [])
                toks = (self.decode(sid, st["done"], n_new, st["state"], history)
                        if n_new > 0 else [])
                if toks:
                    # the consumer's log FIRST, fabric progress after: a crash
                    # between the two resumes from the (longer) consumer log
                    # and never emits a logged token again
                    _log_tokens(self.state_dir, sid, st["done"], toks)
                    history.extend(int(t) for t in toks)
                    st["done"] += len(toks)
                    self.decoded += len(toks)
                progress[sid] = st["done"]
                if st["done"] >= self.gen:
                    finished.append(sid)
            if progress:
                tier.record_progress(progress)
            for sid in finished:
                _log_served(self.state_dir, sid)
                self.served.append(sid)
                tier.mark_served(sid)
            if finished:
                tier.submit([], release_slots=[self.active.pop(sid)["slot"]
                                               for sid in finished])
            if (not self.active and not waiting
                    and next_idx >= len(self.pending) and tier.backlog() == 0):
                break  # nothing left anywhere (lost-session guard)
        return {
            "completed": len(set(self.served) & set(self.sids)),
            "rounds": self.rounds,
            "decoded_tokens": self.decoded,
            "served": list(self.served),
        }


def make_model_decode(cfg, params, prefill_step, serve_step, quantum_step,
                      prompt_len: int, quantum: int, *, device="cuda",
                      times: Optional[Dict[str, List[float]]] = None,
                      hook: Optional[BatchHook] = None):
    """The per-session model decoder the continuous loop drives: it emits
    the next ``n`` greedy tokens of session ``sid`` at batch 1.

    A fresh session prefills its ``default_rng(sid)`` prompt; a resumed one
    re-prefills prompt + committed history (S = ``prompt_len`` + start), so
    greedy decode continues where the crashed run stopped (token for token
    in f32; in bf16 the prefill rounds otherwise than the decode steps it
    replaces, and a near-tie may flip).  The KV cache stays in ``state``
    between rounds; full quanta go through ``quantum_step``, the rest
    through single ``serve_step``s.  ``times`` collects ``prefill_s`` per
    prefill and ``decode_step_s`` per decode step (host clock after a
    device synchronize; a quantum's time split over its steps).
    ``hook(sids=[sid], prompts=, last=, tokens=)`` runs after each prefill
    with its input row (1, S), last-position logits and first token."""
    device = torch.device(device)
    times = times if times is not None else {"prefill_s": [], "decode_step_s": []}

    def decode(sid, start, n, state, history):
        if n <= 0:
            return []
        out: List[int] = []
        if "cache" not in state:
            prompt = np.random.default_rng(sid).integers(0, cfg.vocab, prompt_len)
            row = np.concatenate([prompt, np.asarray(list(history[:start]), np.int64)])
            tokens = torch.from_numpy(row[None, :]).to(device)
            t0 = _clock(device)
            last, cache = prefill_step(params, {"tokens": tokens})
            tok = torch.argmax(last[:, -1], dim=-1)[:, None]
            times["prefill_s"].append(_clock(device) - t0)
            state["cache"], state["tok"] = cache, tok
            out.append(int(tok[0, 0]))
            if hook is not None:
                hook(sids=[sid], prompts=tokens, last=last, tokens=tok)
        while len(out) < n:
            t0 = _clock(device)
            if n - len(out) >= quantum:
                o, state["cache"] = quantum_step(params, state["cache"], state["tok"])
                state["tok"] = o["next_token"]
                new = [int(t) for t in o["tokens"][0].tolist()]
            else:
                o, state["cache"] = serve_step(params, state["cache"], {"tokens": state["tok"]})
                state["tok"] = o["next_token"][:, None]
                new = [int(state["tok"][0, 0])]
            dt = (_clock(device) - t0) / len(new)
            times["decode_step_s"].extend([dt] * len(new))
            out.extend(new)
        return out

    return decode


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="rolling-window decode steps (0: insert-at-length caches); "
                         "only W > 0 is read: the ring is as wide as the prefill's "
                         "cache (prompt_len + gen + 8), as in the reference launcher")
    ap.add_argument("--sessions", type=int, default=0,
                    help="total sessions through the request-queue tier "
                         "(default: one round of --batch)")
    ap.add_argument("--arrival", type=int, default=0,
                    help="arrivals per round (default: --batch)")
    ap.add_argument("--queues", type=int, default=4,
                    help="request-queue shards in the DFC fabric")
    ap.add_argument("--durable", action="store_true",
                    help="run the tier over the SimFS persistence path")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined durable path (dispatch/retire overlap)")
    ap.add_argument("--depth", type=int, default=0,
                    help="pipeline depth D (>1 keeps D-1 chains in flight; "
                         "0 = serial, or 2 with --pipeline)")
    ap.add_argument("--priority", action="store_true",
                    help="deque request shards: high-priority sessions jump "
                         "the line (front-of-queue push)")
    ap.add_argument("--split-lanes", action="store_true",
                    help="per-side combiners: arrivals ride each request "
                         "shard's tail lane, admission pops its head lane, "
                         "with independent epochs and commits")
    ap.add_argument("--high-every", type=int, default=0,
                    help="with --priority: every Nth session arrives "
                         "high-priority (0 = none)")
    ap.add_argument("--k-classes", type=int, default=0,
                    help="continuous-batching mode with k priority classes "
                         "(2..4): per-class queue shards, weighted "
                         "round-robin admission, quantum decode with "
                         "crash-exact resume")
    ap.add_argument("--class-weights", default="",
                    help="comma-separated dequeue credits per class "
                         "(default: 1<<c, i.e. 1,2,4,...)")
    ap.add_argument("--quantum", type=int, default=0,
                    help="decode tokens per session per scheduling round "
                         "(default: min(8, --gen))")
    ap.add_argument("--reshard-backlog", type=int, default=0,
                    help="split a request shard when its backlog exceeds N")
    ap.add_argument("--bulk-arrivals", action="store_true",
                    help="submit the whole arrival schedule up front through "
                         "the fabric's fused K-phase loop, then admit from "
                         "the committed backlog")
    ap.add_argument("--tier-only", action="store_true",
                    help="skip the model: serve = tier admission only")
    ap.add_argument("--state-dir", default="",
                    help="durable tier root (enables crash/resume demos); "
                         "default: fresh temp dir")
    ap.add_argument("--crash-at", type=int, default=0,
                    help="inject a crash at the K-th tier persistence op "
                         "(requires --durable --state-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="recover the tier from --state-dir, reconcile, and "
                         "finish serving")
    ap.add_argument("--expect-exactly-once", action="store_true",
                    help="with --resume: assert every session was served "
                         "exactly once across crash + resume")
    ap.add_argument("--trace", action="store_true",
                    help="enable the fabric flight recorder: durable trace "
                         "sidecar under the tier root (with --state-dir), "
                         "metrics + Chrome trace exports, and p50/p99 "
                         "admission latency in the tier report")
    ap.add_argument("--device", default="cuda")
    return ap


BatchHook = Callable[..., None]


def _clock(device) -> float:
    """Host seconds after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve(args: argparse.Namespace, params: Optional[Dict[str, Any]] = None,
          hook: Optional[BatchHook] = None, cfg: Optional[ModelConfig] = None
          ) -> Dict[str, Any]:
    """Run the launcher and print its report.

    ``cfg`` is the model's configuration (default: ``--arch``'s, reduced
    with ``--reduced``, tuned by ``launch/tuned.py`` as the reference's
    launcher tunes it); ``params`` its parameters (default: ``init_params``
    with seed 0 on ``--device``).  ``hook(sids=, prompts=, last=, tokens=)`` runs
    after each served batch, outside the timed region, with the prefill's
    last-position logits and the greedy tokens (B, gen); with
    ``--k-classes`` after each session's batch-1 prefill instead (see
    ``make_model_decode``).  Returns the run's record: ``tier``, ``cfg``,
    ``params``, ``obs``, ``completed``, ``crashed``, ``decoded_tokens``,
    ``seconds``, the per-prefill ``prefill_s`` and per-step
    ``decode_step_s`` (host clock after a device synchronize), and
    ``batches`` (batch path) or ``rounds`` and ``quantum`` (``--k-classes``).
    """
    if cfg is None:
        cfg = apply_tuning(get_reduced(args.arch) if args.reduced else get_config(args.arch))
    if not args.tier_only and (cfg.embedding_inputs or cfg.family == "vlm"):
        raise SystemExit(f"{args.arch}: frontend-stub arch — see examples/")
    device = resolve_device(args.device)
    k = args.k_classes if args.k_classes >= 2 else 0
    quantum = args.quantum or min(8, args.gen)

    if args.tier_only:
        prefill_step = serve_step = quantum_step = params = None
    else:
        from repro_torch.launch.steps import (
            make_prefill_step,
            make_quantum_step,
            make_serve_step,
        )
        from repro_torch.models.model import init_params

        if params is None:
            params = init_params(cfg, seed=0, device=device)
        max_len = args.prompt_len + args.gen + 8
        prefill_step = make_prefill_step(cfg, max_len=max_len)
        serve_step = make_serve_step(cfg, window=args.window)
        quantum_step = (make_quantum_step(cfg, quantum=quantum, window=args.window)
                        if k else None)

    n_sessions = args.sessions or args.batch
    arrival = args.arrival or args.batch
    depth = args.depth or None
    state_dir = Path(args.state_dir) if args.state_dir else None
    if (args.crash_at or args.resume) and not (args.durable and state_dir):
        raise SystemExit("--crash-at/--resume need --durable and --state-dir")

    fs = None
    if args.durable and state_dir is not None:
        state_dir.mkdir(parents=True, exist_ok=True)
        fs = SimFS(state_dir / "tier", FaultInjector(crash_at=args.crash_at or None))

    obs = None
    if args.trace:
        from repro_torch.obs import FabricObserver

        # durable tiers get the crash-durable sidecar under the tier root;
        # volatile tiers trace in memory (metrics and ring only)
        obs = FabricObserver(root=fs.root if fs is not None else None)

    tier_kw = dict(
        n_queues=args.queues,
        capacity=4096,
        lanes=max(arrival, args.batch) * 2,
        reshard_backlog=args.reshard_backlog or None,
        pipeline=args.pipeline,
        depth=depth,
        priority=args.priority,
        split_lanes=args.split_lanes,
        k_classes=k,
        class_weights=([int(x) for x in args.class_weights.split(",")]
                       if k and args.class_weights else None),
        obs=obs,
        device=device,
    )
    served_before = _read_served(state_dir) if state_dir else []
    out: Dict[str, Any] = {"cfg": cfg, "params": params, "obs": obs, "batches": 0,
                           "crashed": False, "prefill_s": [], "decode_step_s": []}
    if k:
        decode = None
        if not args.tier_only:
            decode = make_model_decode(cfg, params, prefill_step, serve_step, quantum_step,
                                       args.prompt_len, quantum, device=device, times=out,
                                       hook=hook)
        return _serve_continuous(args, decode, quantum, fs, obs, tier_kw, state_dir,
                                 served_before, n_sessions, arrival, out)

    def serve_batch(sids: List[int]) -> None:
        """Prefill + greedy decode of one admitted batch (rows padded to
        ``--batch`` with the first session), or nothing with --tier-only."""
        if args.tier_only or not sids:
            return
        rows = sids + [sids[0]] * (args.batch - len(sids))
        prompts = torch.from_numpy(np.stack([
            np.random.default_rng(sid).integers(0, cfg.vocab, args.prompt_len)
            for sid in rows
        ])).to(device)
        t0 = _clock(device)
        last, cache = prefill_step(params, {"tokens": prompts})
        tok = torch.argmax(last[:, -1], dim=-1)[:, None]
        t1 = _clock(device)
        out["prefill_s"].append(t1 - t0)
        toks = [tok]
        for _ in range(args.gen - 1):
            step, cache = serve_step(params, cache, {"tokens": tok})
            tok = step["next_token"][:, None]
            toks.append(tok)
            t2 = _clock(device)
            out["decode_step_s"].append(t2 - t1)
            t1 = t2
        out["batches"] += 1
        if hook is not None:
            hook(sids=list(sids), prompts=prompts, last=last, tokens=torch.cat(toks, 1))

    waiting: List[int] = []
    in_flight: List[int] = []
    next_idx = 0
    decoded_tokens = 0
    t0 = time.perf_counter()
    round_no = 0
    completed = 0
    tier = None
    try:
        # tier construction and recovery run under the same crash handler:
        # the fault injector ticks through the slot-pool seeding and the
        # resume-time reconciliation too
        if args.resume:
            tier, info = RequestQueueTier.recover(fs, **tier_kw)
            served_set = set(served_before)
            in_flight = [s for s in info["in_flight"] if s not in served_set]
            queued = set(info["queued"])
            to_submit = [
                s for s in range(1, n_sessions + 1)
                if s not in served_set and s not in queued and s not in in_flight
            ]
            # rebuild the slot pool: total slots minus those still free minus
            # the ones in-flight sessions hold (released after service)
            missing = args.batch - len(info["pool"]) - len(in_flight)
            if missing > 0:
                free_ids = [
                    i for i in range(args.batch) if i not in set(info["pool"])
                ][:missing]
                tier.submit([], release_slots=free_ids)
            stages = [st["stage"] for st in info["sessions"].values()]
            print(
                f"resume: served={len(served_set)} queued={len(queued)} "
                f"in_flight={in_flight} lost_arrivals={info['lost_arrivals']} "
                f"resubmitting={len(to_submit)} "
                f"sessions={len(stages)} "
                f"(q={stages.count(SESSION_QUEUED)} "
                f"a={stages.count(SESSION_ADMITTED)} "
                f"s={stages.count(SESSION_SERVED)})"
            )
            pending_sids = to_submit
            completed = len(served_set)
        else:
            tier = RequestQueueTier(slots=args.batch, durable=args.durable, fs=fs, **tier_kw)
            pending_sids = list(range(1, n_sessions + 1))
        # resumed in-flight admissions go first: their dequeue committed
        # before the crash, so they are served (once) without re-queueing
        if in_flight:
            pool = tier.pool_slots()
            slot_src = [i for i in range(args.batch) if i not in set(pool)]
            assert len(slot_src) >= len(in_flight), (slot_src, in_flight)
            pairs = list(zip(in_flight, slot_src))
            serve_batch([sid for sid, _ in pairs])
            decoded_tokens += 0 if args.tier_only else args.gen * len(pairs)
            for sid, slot in pairs:
                _log_served(state_dir, sid)
                tier.mark_served(sid)
                completed += 1
            tier.submit([], release_slots=[slot for _, slot in pairs])
        if args.bulk_arrivals and pending_sids:
            # the whole arrival schedule commits in ONE fused dispatch
            bulk_waves = []
            for i in range(0, len(pending_sids), arrival):
                fresh = pending_sids[i : i + arrival]
                prio = (
                    [1 if s % args.high_every == 0 else 0 for s in fresh]
                    if args.priority and args.high_every else None
                )
                bulk_waves.append((fresh, [], prio))
            rejected = tier.submit_waves(bulk_waves)
            waiting = [s for wave in rejected for s in wave]
            next_idx = len(pending_sids)
            print(
                f"bulk arrivals: {len(pending_sids)} sessions committed in "
                f"{len(bulk_waves)} fused phases ({len(waiting)} to retry)"
            )
        while completed < n_sessions:
            round_no += 1
            fresh = pending_sids[next_idx : next_idx + arrival]
            next_idx += len(fresh)
            prio = None
            if args.priority and args.high_every:
                prio = [1 if s % args.high_every == 0 else 0 for s in waiting + fresh]
            waiting = tier.submit(waiting + fresh, priorities=prio)

            admitted = tier.admit(args.batch)
            if not admitted:
                if not fresh and not waiting and tier.backlog() == 0:
                    break  # nothing left anywhere (lost-session guard)
                continue
            sids = [sid for sid, _ in admitted]
            serve_batch(sids)
            decoded_tokens += 0 if args.tier_only else args.gen * len(sids)
            for sid in sids:
                _log_served(state_dir, sid)
                tier.mark_served(sid)
            completed += len(sids)
            # sessions finished: their decode slots go back through the fabric
            tier.submit([], release_slots=[slot for _, slot in admitted])
    except CrashNow as e:
        print(f"CRASHED: {e}")
        print(f"tier state is durable under {state_dir}; resume with "
              f"--resume --state-dir {state_dir}")
        out.update(tier=tier, crashed=True, completed=completed)
        return out
    dt = time.perf_counter() - t0

    print(
        f"{args.arch}: served {completed} sessions in {round_no} rounds, "
        f"{decoded_tokens} tok in {dt*1e3:.0f} ms"
        + ("" if args.tier_only or dt == 0 else f" ({decoded_tokens/dt:.0f} tok/s)")
    )
    print(
        f"request tier: queues={tier.n_queues} (+ slot-pool stack shard "
        f"+ session-state map shard) "
        f"priority={args.priority} depth={tier.rt.depth} "
        f"arrived={tier.stats['arrived']} admitted={tier.stats['admitted']} "
        f"rejected={tier.stats['rejected']} splits={tier.stats['splits']} "
        f"backlog={tier.backlog()}"
    )
    if tier.split_lanes:
        pairs = " ".join(f"s{s}=[{e[0]},{e[1]}]"
                         for s, e in sorted((tier.rt.lane_stats() or {}).get("epochs", {}).items()))
        print(f"split lanes: head/tail epochs {pairs}")
    if out["prefill_s"]:
        steps = sorted(out["decode_step_s"])
        med = steps[len(steps) // 2] * 1e3 if steps else float("nan")
        print(f"model: {cfg.name} on {device}, prefill "
              f"{args.batch * args.prompt_len * len(out['prefill_s']) / sum(out['prefill_s']):.0f}"
              f" tok/s over {len(out['prefill_s'])} batches, decode median {med:.3f} ms/step")
    p = tier.persistence_stats()
    if p:
        print(f"pwb/op: {p['pwb_per_op']:.2f}  pfence/op: {p['pfence_per_op']:.2f}")
    _print_latency(tier)
    if obs is not None:
        from repro_torch.obs import bridge_persist_stats, to_chrome_trace

        if tier.durable:
            bridge_persist_stats(obs.metrics, tier.rt.fs.pstats)
        obs.flush()  # clean shutdown: the tail since the last fence
        if obs.root is not None:
            n_m = obs.metrics.to_jsonl(obs.root / "obs" / "metrics.jsonl")
            n_e = to_chrome_trace(obs.trace.events(), obs.root / "obs" / "trace_chrome.json")
            print(f"trace: {obs.trace_path} (+{n_m} metrics, "
                  f"{n_e} chrome events under {obs.root / 'obs'})")
    if args.expect_exactly_once:
        served = _read_served(state_dir)
        expect = sorted(range(1, n_sessions + 1))
        assert sorted(served) == expect and len(served) == len(set(served)), (
            f"exactly-once violated: served={sorted(served)} expected={expect}"
        )
        print(f"exactly-once OK: {n_sessions} sessions, none lost, none duplicated")
    out.update(tier=tier, completed=completed, decoded_tokens=decoded_tokens, seconds=dt)
    return out


def _print_latency(tier: RequestQueueTier) -> None:
    for name, st in (tier.latency_stats() or {}).items():
        print(f"{name}: p50={st['p50']:.3f} p99={st['p99']:.3f} "
              f"mean={st['mean']:.3f} n={int(st['count'])}")


def _serve_continuous(args, decode, quantum, fs, obs, tier_kw, state_dir, served_before,
                      n_sessions, arrival, out) -> Dict[str, Any]:
    """The launcher's ``--k-classes`` branch: the continuous-batching server
    (``decode`` None serves the simulated tokens of ``--tier-only``), crash
    and resume through the consumer logs plus one recovery walk."""
    sids = list(range(1, n_sessions + 1))
    tier = None
    t0 = time.perf_counter()
    try:
        if args.resume:
            tier, info = RequestQueueTier.recover(fs, **tier_kw)
        else:
            tier = RequestQueueTier(slots=args.batch, durable=args.durable, fs=fs, **tier_kw)
            info = None
        entries = _read_token_entries(state_dir)
        srv = ContinuousServer(
            tier, sids=sids, batch=args.batch, gen=args.gen, quantum=quantum,
            arrival=arrival, class_of=lambda s: s % args.k_classes, state_dir=state_dir,
            decode=decode, resume_info=info, served_before=served_before,
            token_log={s: _committed_tokens(e) for s, e in entries.items()},
        )
        if info is not None:
            print(
                f"resume: served={len(set(served_before))} "
                f"in_flight={sorted(srv.active)} "
                f"lost_arrivals={info['lost_arrivals']} "
                f"resubmitting={len(srv.pending)} "
                f"progress={ {s: st['done'] for s, st in sorted(srv.active.items())} }"
            )
        res = srv.run()
    except CrashNow as e:
        print(f"CRASHED: {e}")
        print(f"tier state is durable under {state_dir}; resume with "
              f"--resume --state-dir {state_dir}")
        out.update(tier=tier, crashed=True, completed=None, quantum=quantum)
        return out
    dt = time.perf_counter() - t0

    print(
        f"{args.arch}: continuous batching served {res['completed']}/"
        f"{n_sessions} sessions in {res['rounds']} rounds, "
        f"{res['decoded_tokens']} tok (quantum={quantum}) in {dt*1e3:.0f} ms"
        + ("" if args.tier_only or dt == 0
           else f" ({res['decoded_tokens']/dt:.0f} tok/s)")
    )
    print(
        f"k-class tier: k={tier.k_classes} weights={tier.class_weights} "
        f"starvation_bound={tier.starvation_bound()} "
        f"arrived={tier.stats['arrived']} admitted={tier.stats['admitted']} "
        f"rejected={tier.stats['rejected']} backlog={tier.backlog()}"
    )
    if out["prefill_s"]:
        pre, steps = sorted(out["prefill_s"]), sorted(out["decode_step_s"])
        med = steps[len(steps) // 2] * 1e3 if steps else float("nan")
        print(f"model: {out['cfg'].name} on {tier.rt.device}, {len(pre)} prefills at "
              f"batch 1, median {pre[len(pre) // 2] * 1e3:.3f} ms; {len(steps)} decode "
              f"steps at batch 1, median {med:.3f} ms/step")
    p = tier.persistence_stats()
    if p:
        print(f"pwb/op: {p['pwb_per_op']:.2f}  pfence/op: {p['pfence_per_op']:.2f}")
    _print_latency(tier)
    if obs is not None:
        obs.flush()
    if args.expect_exactly_once:
        verify_exactly_once(sids, args.gen, _read_served(state_dir),
                            _read_token_entries(state_dir))
        print("exactly-once: OK (sessions + token indices)")
    out.update(tier=tier, completed=res["completed"], rounds=res["rounds"],
               decoded_tokens=res["decoded_tokens"], seconds=dt, quantum=quantum)
    return out


def main(argv=None) -> None:
    serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
