"""DFC deque — the paper's detectable flat-combining persistent double-ended
queue (counterpart of the JAX package's ``core/dfc_deque.py``).

Algorithm 1's announce / lock hand-off / recover skeleton is inherited from
:class:`~repro_torch.core.dfc.DFCBase`; this module supplies the deque's
REDUCE/COMBINE over the simulated NVM.

Layout (deque analogue of Figure 1):
  NVM lines:
    'cEpoch'          {v}          global epoch counter (shared skeleton)
    'left'            {0, 1}       two alternating left-end pointers
    'right'           {0, 1}       two alternating right-end pointers
    ('valid', t), ('ann', t, s)    as in the stack
    ('pool', i)       {param, next, prev}   doubly-linked nodes, one cache
                       line each (``next`` points toward the right end)
  Volatile:
    cLock, rLock, pushLList/popLList/pushRList/popRList[N], vColl[N]

Combiner algorithm (one phase, lock held):
  1. REDUCE collects announced ops into the four side lists and eliminates
     SAME-SIDE pairs exactly as the stack does (a pushL_k;popL_k adjacent
     pair returns the pushed value and leaves the deque unchanged; ditto R).
     After elimination each side has a one-sided surplus.
  2. The left surplus is applied first (pushes prepend / pops consume from
     the left, in collection order), then the right surplus — this is the
     canonical linearization order, shared with the vectorized layer.
  3. Consumed nodes are only deallocated after the phase commits (a deque
     phase can free on one side and allocate on the other; early reuse would
     corrupt the committed chain a crash rolls back to).
  4. End-node mutations are confined to fields the committed state never
     reads: appending right writes ``next`` of the committed right end,
     prepending left writes ``prev`` of the committed left end.  Committed
     traversal is bounded by the committed (left, right) pair, so dangling
     links beyond either end are unreachable after a rollback (recovery GC
     and ``snapshot`` stop at the right end for the same reason).
  5. The phase publishes by writing the *inactive* left/right entries and
     committing with the shared two-increment epoch protocol.

Paper correspondence (arXiv:2012.12868; shared skeleton cites are in
``repro_torch.core.dfc``):
  * announce / valid / recovery skeleton: Alg. 1 lines 2-12 and 26-43 via
    :class:`~repro_torch.core.dfc.DFCBase`,
  * elimination rule: the same-side instance of Alg. 2 lines 102-110 —
    pushL_k pairs with popL_k (and pushR_k with popR_k); cross-side pairs
    are NOT eliminated, they linearize through the structure (step 2),
  * one pfence per phase / two-increment ``cEpoch`` commit: Alg. 2 line 80
    and Alg. 1 lines 81-83 with the (left, right) double-buffered roots,
  * deferred node reuse + bounded recovery GC walks: §4, extended to
    doubly-linked nodes (walks bounded by the committed (left, right) pair).
"""

from __future__ import annotations

from typing import Any, Dict, Generator

from repro_torch.core.dfc import ACK, EMPTY, POPL, POPR, PUSHL, PUSHR, DFCBase
from repro_torch.nvm.pool import NIL


class DFCDeque(DFCBase):
    SEMANTICS = "deque"
    DRAIN_OP = POPL
    POOL_EXTRA_FIELDS = ("prev",)

    def _alloc_structure(self) -> None:
        self.mem.alloc_line("left", **{"0": NIL, "1": NIL})
        self.mem.alloc_line("right", **{"0": NIL, "1": NIL})

    def _extra_volatile(self) -> Dict[str, Any]:
        n = self.N
        return dict(
            pushLList=[0] * n,
            popLList=[0] * n,
            pushRList=[0] * n,
            popRList=[0] * n,
        )

    def _gc_roots(self):
        c_epoch = self.mem.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        left = self.mem.read("left", e)
        right = self.mem.read("right", e)
        return [left], [right]

    _LISTS = {
        PUSHL: "pushLList",
        POPL: "popLList",
        PUSHR: "pushRList",
        POPR: "popRList",
    }

    def _route(self, i: int, op_name: str) -> None:
        counts = self._counts
        counts[op_name] += 1
        self.vol[self._LISTS[op_name]][counts[op_name] - 1] = i

    # ---------------------------------------------------------------- Reduce
    def reduce(self, t: int) -> Generator:
        """Collect the four op kinds, then eliminate same-side pairs.

        Returns (l_surplus, r_surplus): positive = that many surplus pushes
        on the side, negative = surplus pops, zero = fully eliminated.
        """
        m = self.mem
        vol = self.vol
        self._counts = {PUSHL: 0, POPL: 0, PUSHR: 0, POPR: 0}
        yield from self._collect(t)
        c = self._counts
        surpluses = []
        for push_name, pop_name in ((PUSHL, POPL), (PUSHR, POPR)):
            n_push, n_pop = c[push_name], c[pop_name]
            push_list = vol[self._LISTS[push_name]]
            pop_list = vol[self._LISTS[pop_name]]
            while n_push > 0 and n_pop > 0:  # eliminate from the lists' tails
                c_push = push_list[n_push - 1]
                c_pop = pop_list[n_pop - 1]
                v_push = vol["vColl"][c_push]
                yield
                m.write(("ann", c_push, v_push), "val", ACK)
                v_pop = vol["vColl"][c_pop]
                yield
                param = m.read(("ann", c_push, v_push), "param")
                m.write(("ann", c_pop, v_pop), "val", param)
                n_push -= 1
                n_pop -= 1
                self.eliminated_pairs += 1
            surpluses.append(n_push if n_push > 0 else -n_pop)
        return surpluses[0], surpluses[1]

    # --------------------------------------------------------------- Combine
    def combine(self, t: int) -> Generator:
        m = self.mem
        vol = self.vol
        l_surplus, r_surplus = yield from self.reduce(t)
        yield
        c_epoch = m.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        left = m.read("left", e)
        right = m.read("right", e)
        freed = []  # deallocated only after the phase commits (see docstring)

        sides = (
            (l_surplus, "pushLList", "popLList", True),
            (r_surplus, "pushRList", "popRList", False),
        )
        for surplus, push_list, pop_list, is_left in sides:
            if surplus > 0:  # surplus pushes on this side
                for k in range(surplus):
                    c_id = vol[push_list][k]
                    v_op = vol["vColl"][c_id]
                    yield
                    param = m.read(("ann", c_id, v_op), "param")
                    yield
                    if is_left:
                        node = self.pool.allocate(param, left, prev=NIL)
                    else:
                        node = self.pool.allocate(param, NIL, prev=right)
                    yield
                    m.write(("ann", c_id, v_op), "val", ACK)
                    yield
                    m.pwb(t, self.pool.line_of(node), tag="combine")
                    if is_left:
                        if left == NIL:
                            right = node
                        else:
                            yield
                            self.pool.set(left, "prev", node)
                            yield
                            m.pwb(t, self.pool.line_of(left), tag="combine")
                        left = node
                    else:
                        if right == NIL:
                            left = node
                        else:
                            yield
                            self.pool.set(right, "next", node)
                            yield
                            m.pwb(t, self.pool.line_of(right), tag="combine")
                        right = node
            elif surplus < 0:  # surplus pops on this side
                for k in range(-surplus):
                    c_id = vol[pop_list][k]
                    v_op = vol["vColl"][c_id]
                    if left == NIL:
                        yield
                        m.write(("ann", c_id, v_op), "val", EMPTY)
                        continue
                    end = left if is_left else right
                    yield
                    m.write(("ann", c_id, v_op), "val", self.pool.param(end))
                    freed.append(end)
                    if left == right:  # never follow links past the ends
                        left = right = NIL
                    elif is_left:
                        left = self.pool.next(left)
                    else:
                        right = self.pool.get(right, "prev")

        # ---- publish ------------------------------------------------------
        ne = self._next_top_entry(c_epoch)
        yield
        m.write("left", ne, left)
        yield
        m.write("right", ne, right)
        yield from self._publish(t, c_epoch, ("left", "right"))
        for idx in freed:
            self.pool.deallocate(idx)

    # ------------------------------------------------------------ inspection
    def peek_deque(self):
        """Volatile view of the active deque, left to right (test helper)."""
        c_epoch = self.mem.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        left = self.mem.read("left", e)
        right = self.mem.read("right", e)
        if left == NIL:
            return []
        return self.pool.walk(left, stop=right)

    def snapshot(self):
        return self.peek_deque()
