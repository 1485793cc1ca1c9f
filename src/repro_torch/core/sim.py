"""Deterministic cooperative scheduler for the simulated concurrent threads
(counterpart of the JAX package's ``core/sim.py``).

Threads are Python generators that ``yield`` before every shared-memory step
(read / write / CAS / pwb / pfence) — one yield == one atomic step.  The
scheduler interleaves live threads with a seeded RNG, which gives:

  * deterministic, replayable interleavings (seed → schedule),
  * precise crash injection: ``crash_at=k`` stops the world exactly before
    global step ``k``, after which the harness calls ``NVMemory.crash`` and
    runs the recovery generators.

This is (sequentially-consistent) shared memory — a sound under-approximation
of the paper's TSO assumption for correctness testing, since every SC
execution is a TSO execution.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generator, Hashable, List, Optional, Tuple

import numpy as np


class Crashed(Exception):
    """Raised by Scheduler.run when the injected crash point is reached."""


class Livelock(Exception):
    """No thread finished within the step budget (scheduler bug trap)."""


class Scheduler:
    def __init__(self, seed: int = 0, max_steps: int = 5_000_000):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.step = 0  # global step counter (also used as event timestamps)

    def run(
        self,
        gens: Dict[Hashable, Generator],
        crash_at: Optional[int] = None,
    ) -> Dict[Hashable, Any]:
        """Drive all generators to completion (or until ``crash_at``).

        Returns {tid: return_value}.  Raises :class:`Crashed` if the crash
        point is reached before all threads finish.
        """
        live = dict(gens)
        results: Dict[Hashable, Any] = {}
        budget = self.step + self.max_steps
        while live:
            if crash_at is not None and self.step >= crash_at:
                raise Crashed()
            if self.step >= budget:
                raise Livelock(f"no progress after {self.max_steps} steps")
            tid = list(live.keys())[int(self.rng.integers(len(live)))]
            try:
                next(live[tid])
                self.step += 1
            except StopIteration as fin:
                results[tid] = fin.value
                del live[tid]
        return results


# --------------------------------------------------------------------- events
class History:
    """Invocation/response event log for linearizability checking."""

    def __init__(self):
        self.ops: List[dict] = []

    def invoke(self, tid, name, param, ts) -> int:
        self.ops.append(
            dict(tid=tid, name=name, param=param, inv=ts, resp=None, value=None)
        )
        return len(self.ops) - 1

    def respond(self, op_id: int, value, ts) -> None:
        self.ops[op_id]["resp"] = ts
        self.ops[op_id]["value"] = value

    def pending(self) -> List[dict]:
        return [o for o in self.ops if o["resp"] is None]

    def completed(self) -> List[dict]:
        return [o for o in self.ops if o["resp"] is not None]


def workload_gen(stack, sched: Scheduler, hist: History, tid, ops, think=None, rng=None):
    """Run a per-thread op sequence against ``stack``, logging the history.

    ``think=(lo, hi)`` inserts a random number of idle steps between ops —
    the arrival jitter real machines have.  Without it, a fair scheduler
    keeps alternating workloads in parity lockstep (all-push batches, then
    all-pop batches), which suppresses elimination.
    """
    for name, param in ops:
        if think is not None:
            for _ in range(int(rng.integers(think[0], think[1] + 1))):
                yield
        op_id = hist.invoke(tid, name, param, sched.step)
        value = yield from stack.op(tid, name, param)
        hist.respond(op_id, value, sched.step)
    return True
