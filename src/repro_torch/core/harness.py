"""Crash-injection harness for the DFC structures (stack, queue, deque);
counterpart of the JAX package's ``core/harness.py``.

Drives a workload to a chosen global step, crashes the simulated NVM (with a
chosen eviction adversary), runs the Recover procedure for every thread —
possibly crashing *again* during recovery — and assembles the *effective
history* needed to check durable linearizability + detectability.

Detectability protocol used by the harness (mirrors the paper §2's contract):
after Recover returns, a thread inspects its active announcement.  If the
announcement matches the op it had in flight, the op took effect and
Recover's return value is its response; otherwise the op did not take effect
(its announcement never became valid) and it may be safely re-executed.

To make the announcement-identity check exact, the harness gives every
param-less op (pop/deq/popL/popR) a unique token as its ``param`` — the
announcement's param field is ignored by the combiners for removals, so the
token rides along purely as an operation identifier (the standard
sequence-number technique for detectable objects).  Without it, a thread
whose previous op had the same name could be mis-detected after a crash that
hit the announce sequence before the valid-bit flip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.dfc import BOT, INIT, DFCBase, DFCStack
from repro_torch.core.linearize import is_linearizable
from repro_torch.core.sim import Crashed, History, Scheduler, workload_gen
from repro_torch.nvm.memory import CrashMode, NVMemory

RECOVERY_TS = 10**8  # response timestamp of ops completed by Recover


@dataclasses.dataclass
class CrashRunResult:
    crashed: bool
    history: History
    stack: DFCBase  # the structure under test (stack/queue/deque)
    mem: NVMemory
    recovered: Dict[int, Any]  # tid -> Recover return value
    effective_ops: List[dict]  # completed + taken-effect pending ops
    took_effect: Dict[int, bool]  # tid(pending only) -> bool


def _tag_ops(
    workloads: Sequence[Sequence[Tuple[str, Any]]]
) -> List[List[Tuple[str, Any]]]:
    """Unique tokens for param-less ops; asserts all params are unique."""
    out: List[List[Tuple[str, Any]]] = []
    for t, w in enumerate(workloads):
        out.append(
            [
                (name, param if param is not None else ("tok", t, i))
                for i, (name, param) in enumerate(w)
            ]
        )
    params = [p for w in out for (_, p) in w]
    assert len(params) == len(set(params)), "harness requires unique op params"
    return out


def run_with_crash(
    workloads: Sequence[Sequence[Tuple[str, Any]]],
    crash_at: Optional[int],
    seed: int = 0,
    mode: CrashMode = CrashMode.MIN,
    recovery_crash_at: Optional[int] = None,
    pool_capacity: int = 1024,
    structure: Type[DFCBase] = DFCStack,
) -> CrashRunResult:
    workloads = _tag_ops(workloads)
    n = len(workloads)
    mem = NVMemory()
    obj = structure(mem, n, pool_capacity=pool_capacity)
    sched = Scheduler(seed=seed)
    hist = History()
    rng = np.random.default_rng(seed + 1)

    gens = {t: workload_gen(obj, sched, hist, t, workloads[t]) for t in range(n)}
    try:
        sched.run(gens, crash_at=crash_at)
        return CrashRunResult(False, hist, obj, mem, {}, list(hist.ops), {})
    except Crashed:
        pass

    # ------------------------------------------------------------- the crash
    mem.crash(mode, rng=rng)
    obj.reset_volatile()

    # ---------------------------------------------------------- recovery (+N crashes)
    while True:
        rec_gens = {t: obj.recover(t) for t in range(n)}
        try:
            recovered = sched.run(rec_gens, crash_at=recovery_crash_at)
            break
        except Crashed:
            recovery_crash_at = None  # second recovery runs to completion
            mem.crash(mode, rng=rng)
            obj.reset_volatile()

    # -------------------------------------------- effective history assembly
    effective = list(hist.completed())
    took_effect: Dict[int, bool] = {}
    pending_by_tid = {o["tid"]: o for o in hist.pending()}
    for tid, op in pending_by_tid.items():
        name, param, val = obj.active_announcement(tid)
        # Exact announcement identity: every op carries a unique param (tokens
        # for removals), so the valid slot holds THIS op iff name+param match;
        # the op took effect iff its response was (or has now been) computed.
        matches = (
            name == op["name"]
            and param == op["param"]
            and val is not BOT
            and val != INIT
        )
        took_effect[tid] = bool(matches)
        if matches:
            eff = dict(op)
            eff["value"] = recovered[tid]
            # Completed at recovery: concurrent with everything pending at the
            # crash, but strictly before any post-recovery op (e.g. the drain,
            # which starts at ts 10^9).  Leaving resp=None (= +inf) is also
            # sound but makes these ops concurrent with the whole drain and
            # blows up the linearizability search.
            eff["resp"] = RECOVERY_TS
            effective.append(eff)
    return CrashRunResult(True, hist, obj, mem, recovered, effective, took_effect)


def drain_ops(result: CrashRunResult, seed: int = 99) -> List[dict]:
    """Remove everything from the recovered structure via fresh ops; return
    the drain history (appended after recovery, so timestamps are later).

    The drain is single-threaded: a sequential drain pins the exact order of
    the recovered contents (a stronger check than a concurrent drain) and
    keeps the linearizability DFS linear in the drain length — n concurrent
    drain threads produce a combinatorial number of interchangeable EMPTY
    removals that blow the checker's search space up.
    """
    obj = result.stack
    sched = Scheduler(seed=seed)
    hist = History()
    base = 10**9  # timestamps after everything else
    sched.step = base
    depth = len(obj.snapshot())
    drain = [(obj.DRAIN_OP, None)] * (depth + 2)
    gens = {0: workload_gen(obj, sched, hist, 0, drain)}
    sched.run(gens)
    return hist.ops


def check_durable_linearizability(
    result: CrashRunResult, drain: bool = True
) -> bool:
    ops = list(result.effective_ops)
    if drain:
        ops += drain_ops(result)
    return is_linearizable(ops, semantics=result.stack.SEMANTICS)


def total_steps(
    workloads,
    seed=0,
    pool_capacity: int = 1024,
    structure: Type[DFCBase] = DFCStack,
) -> int:
    """Step count of the crash-free run (for exhaustive crash sweeps)."""
    workloads = _tag_ops(workloads)
    n = len(workloads)
    mem = NVMemory()
    obj = structure(mem, n, pool_capacity=pool_capacity)
    sched = Scheduler(seed=seed)
    hist = History()
    gens = {t: workload_gen(obj, sched, hist, t, workloads[t]) for t in range(n)}
    sched.run(gens)
    return sched.step
