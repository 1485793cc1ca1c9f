"""Multi-thread announcing driver for the sharded DFC fabric.

Counterpart of the JAX package's ``runtime/announce_driver.py``: a
SIMULATED-CONCURRENCY driver over the port's ``ShardedDFCRuntime``.

  * ``n_threads`` announcers each hold a FIFO of submitted batches and
    per-thread MONOTONE tokens (the recovery protocol's ordering contract);
  * a seeded scheduler interleaves two kinds of atomic actions -- thread t
    announces its next batch, or the combiner runs one ``combine_phase`` --
    chosen uniformly at random among the actions that are currently legal;
  * the rng is a ``numpy.random.default_rng(seed)`` that only ever chooses
    among a deterministically ordered action list, so the same seed and
    submissions replay the SAME interleaving, op for op, here and in the
    reference.

A thread blocks until the combiner has dispatched its current announcement
before publishing the next one, so at most one READY batch per thread
exists at a time; a pipelined runtime may additionally hold its previous
batch un-retired in flight.

``dispatch_order`` records one tuple of (thread, token) pairs per chained
batch, in dispatch order: the fabric's linearization witness (announcements
grouped into one batch combine as ONE phase).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import EV_SCHED
from repro_torch.runtime.dfc_shard import ShardedDFCRuntime


class MultiThreadDriver:
    """Seeded interleaver of ``n_threads`` announcers over one fabric.

    ``rt`` must be a durable ``ShardedDFCRuntime`` (``fs`` set).  Typical
    use::

        drv = MultiThreadDriver(rt, seed=7)
        for t in range(rt.n_threads):
            drv.submit(t, keys, ops, params)      # token assigned, FIFO
        drv.run()                                 # announce/combine/flush
        drv.responses(t, token)                   # durable responses

    After a crash, build a fresh driver on the recovered runtime with
    ``start_tokens`` so per-thread tokens continue monotonically::

        rt2, report = ShardedDFCRuntime.recover(...)
        drv2 = MultiThreadDriver(rt2, seed=seed, start_tokens=drv.tokens)
    """

    def __init__(
        self,
        rt: ShardedDFCRuntime,
        *,
        seed: int = 0,
        start_tokens: Optional[Dict[int, int]] = None,
    ):
        if rt.fs is None:
            raise ValueError("MultiThreadDriver needs a durable runtime (fs)")
        self.rt = rt
        self.n_threads = rt.n_threads
        self.rng = np.random.default_rng(seed)
        self.pending: Dict[int, deque] = {
            t: deque() for t in range(self.n_threads)
        }
        # per-thread monotone token counters (last token ASSIGNED)
        self.tokens: Dict[int, int] = {
            t: int((start_tokens or {}).get(t, 0)) for t in range(self.n_threads)
        }
        # token -> (keys, ops, params) per thread, for oracles and replay
        self.history: Dict[int, Dict[int, Tuple[list, list, list]]] = {
            t: {} for t in range(self.n_threads)
        }
        self.trace: List[Tuple[Any, ...]] = []
        # one tuple of (thread, token) pairs per chained batch, dispatch order
        self.dispatch_order: List[Tuple[Tuple[int, int], ...]] = []
        # announced-but-undispatched batches (thread -> token), maintained by
        # the driver so legality checks stay O(1) per step instead of
        # re-reading every thread's durable announcement record; seeded once
        # from the runtime for batches announced before this driver existed
        # (e.g. re-registered by recovery)
        self._ready: Dict[int, int] = {
            t: rec["token"] for t, rec in rt._collect_ready()
        }

    # ------------------------------------------------------------ submission
    def submit(self, thread: int, keys, ops, params) -> int:
        """Queue one batch on ``thread``; returns its (monotone) token."""
        self.tokens[thread] += 1
        token = self.tokens[thread]
        rec = (
            [int(k) for k in np.asarray(keys)],
            [int(o) for o in np.asarray(ops)],
            [float(p) for p in np.asarray(params)],
        )
        self.pending[thread].append((token,) + rec)
        self.history[thread][token] = rec
        return token

    # ------------------------------------------------------------- scheduling
    def _actions(self) -> List[Tuple[Any, ...]]:
        """Legal atomic actions, deterministically ordered."""
        acts: List[Tuple[Any, ...]] = [
            ("announce", t)
            for t in range(self.n_threads)
            if self.pending[t] and t not in self._ready
        ]
        if self._ready or self.rt._inflight:
            acts.append(("combine",))
        return acts

    def step(self) -> Optional[Tuple[Any, ...]]:
        """Execute one scheduler-chosen action; None when fully drained.

        A crash scheduled by the runtime's fault injector propagates out of
        here (``CrashNow``) exactly as it would out of a direct
        announce/combine call.
        """
        acts = self._actions()
        if not acts:
            return None
        act = acts[int(self.rng.integers(len(acts)))]
        obs = self.rt.obs
        if act[0] == "announce":
            t = act[1]
            token, keys, ops, params = self.pending[t][0]
            if obs.enabled:  # the scheduler's pick, recorded BEFORE the action
                # so a crash inside it still shows what was being attempted
                obs.event(EV_SCHED, action="announce", thread=t, token=token,
                          choices=len(acts))
            # announce may force-retire in-flight chains (slot reclaim, depth
            # > 2); pop the batch only after it lands so a crash inside the
            # announce leaves it resubmittable
            self.rt.announce(t, keys, ops, params, token=token)
            self.pending[t].popleft()
            self._ready[t] = token
            self.trace.append(("announce", t, token))
        else:
            if obs.enabled:
                obs.event(EV_SCHED, action="combine", ready=sorted(self._ready),
                          choices=len(acts))
            self.rt.last_dispatch = []
            self.rt.combine_phase()
            groups = [tuple(g) for g in self.rt.last_dispatch]
            for g in groups:
                for t, _ in g:
                    self._ready.pop(t, None)
            self.dispatch_order.extend(groups)
            self.trace.append(("combine", tuple(groups)))
        return act

    def run(self, max_steps: int = 100_000) -> List[Tuple[Any, ...]]:
        """Drive the schedule to quiescence: every submitted batch announced,
        combined, and retired (``combine_phase`` with nothing ready flushes
        the pipeline).  Returns the executed action trace."""
        for _ in range(max_steps):
            if self.step() is None:
                self.rt.flush()
                return self.trace
        raise RuntimeError("driver failed to drain (livelocked schedule?)")

    # -------------------------------------------------------------- readback
    def responses(self, thread: int, token: int):
        """Durable responses of (thread, token) — ``read_responses`` sugar
        that also raises ``StaleTokenError`` for overwritten records."""
        return self.rt.read_responses(thread, token=token)

    def unsurfaced(self, report: Dict[int, Dict[str, Any]]) -> List[Tuple[int, int]]:
        """(thread, token) pairs this driver submitted that a recovery
        report does not account for — batches the crashed run never
        announced (or whose announce never published).  Re-drive them, in
        token order per thread, to complete the schedule after
        ``replay_pending``."""
        out = []
        for t in range(self.n_threads):
            r = report.get(t) or {"token": None}
            surfaced = r["token"] or 0
            for token in sorted(self.history[t]):
                if token > surfaced:
                    out.append((t, token))
        return out
