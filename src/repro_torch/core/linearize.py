"""Durable-linearizability checker — Wing & Gong style DFS, bitmask-pruned
(counterpart of the JAX package's ``core/linearize.py``).

Checks whether a concurrent history of operations is linearizable with
respect to sequential stack (LIFO), queue (FIFO), or deque semantics.
Histories are lists of op dicts (``repro_torch.core.sim.History`` format):
{name, param, inv, resp, value}.

Durable linearizability with detectability reduces to plain linearizability
of the *effective* history: completed ops keep their timestamps; operations
pending at a crash that the recovery reports as taken-effect are included
with a response timestamp at recovery time (they completed during Recover,
before any post-recovery op); operations reported as not-taken-effect are
excluded.

Implementation notes (the search is exercised hundreds of times per crash
sweep, so constants matter):

  * the linearized-set is an int bitmask; eligibility of op ``i`` is one AND
    against a precomputed ``before[i]`` mask (ops that responded before ``i``
    invoked),
  * memoization on (mask, abstract-state),
  * symmetry reduction: two not-yet-linearized ops with identical
    (name, param, value, before, after) signatures are interchangeable, so
    only the first is tried per DFS node — this collapses the factorial
    branching of concurrent identical EMPTY pops.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

from repro_torch.core.dfc import ACK, DEQ, EMPTY, ENQ, POP, POPL, POPR, PUSH, PUSHL, PUSHR

INF = math.inf


# ------------------------------------------------------------- op semantics
def _apply_stack(state: Tuple, name, param, value) -> Optional[Tuple]:
    if name == PUSH:
        if value not in (ACK, None):
            return None
        return state + (param,)
    if name == POP:
        if not state:
            return state if value == EMPTY else None
        if value != state[-1]:
            return None
        return state[:-1]
    return None


def _apply_queue(state: Tuple, name, param, value) -> Optional[Tuple]:
    if name == ENQ:
        if value not in (ACK, None):
            return None
        return state + (param,)
    if name == DEQ:
        if not state:
            return state if value == EMPTY else None
        if value != state[0]:
            return None
        return state[1:]
    return None


def _apply_deque(state: Tuple, name, param, value) -> Optional[Tuple]:
    if name in (PUSHL, PUSHR):
        if value not in (ACK, None):
            return None
        return (param,) + state if name == PUSHL else state + (param,)
    if name in (POPL, POPR):
        if not state:
            return state if value == EMPTY else None
        end = state[0] if name == POPL else state[-1]
        if value != end:
            return None
        return state[1:] if name == POPL else state[:-1]
    return None


SEMANTICS: dict = {
    "stack": _apply_stack,
    "queue": _apply_queue,
    "deque": _apply_deque,
}


def is_linearizable(
    ops: List[dict], max_nodes: int = 2_000_000, semantics: str = "stack"
) -> bool:
    """DFS with memoization on (linearized-mask, abstract-state)."""
    n = len(ops)
    if n == 0:
        return True
    apply_op = SEMANTICS[semantics]
    resp = [o["resp"] if o["resp"] is not None else INF for o in ops]
    inv = [o["inv"] for o in ops]
    name = [o["name"] for o in ops]
    param = [o["param"] for o in ops]
    value = [o["value"] for o in ops]

    # before[i]: ops that must be linearized before i (responded before i's
    # invocation).  i is eligible at mask iff mask & before[i] == 0 (mask =
    # not-yet-linearized set).
    before = [0] * n
    for i in range(n):
        for j in range(n):
            if j != i and resp[j] < inv[i]:
                before[i] |= 1 << j
    after = [0] * n
    for i in range(n):
        for j in range(n):
            if before[j] >> i & 1:
                after[i] |= 1 << j

    sig = [(name[i], param[i], value[i], before[i], after[i]) for i in range(n)]

    seen = set()
    budget = [max_nodes]
    full = (1 << n) - 1

    def dfs(mask: int, state: Tuple) -> bool:
        """mask = bitmask of ops NOT yet linearized."""
        if mask == 0:
            return True
        key = (mask, state)
        if key in seen:
            return False
        seen.add(key)
        if budget[0] <= 0:
            raise RuntimeError("linearizability search budget exhausted")
        budget[0] -= 1
        tried = set()
        m = mask
        while m:
            low = m & -m
            i = low.bit_length() - 1
            m ^= low
            if mask & before[i]:
                continue  # a predecessor is still unlinearized
            if sig[i] in tried:
                continue  # interchangeable with an already-tried candidate
            tried.add(sig[i])
            nxt = apply_op(state, name[i], param[i], value[i])
            if nxt is None:
                continue
            if dfs(mask ^ low, nxt):
                return True
        return False

    return dfs(full, ())
