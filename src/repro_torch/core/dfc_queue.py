"""DFC queue — the paper's detectable flat-combining persistent FIFO queue
(counterpart of the JAX package's ``core/dfc_queue.py``).

Same three-part design as the stack (`repro_torch.core.dfc`): Algorithm 1's
announce / lock hand-off / recover skeleton is inherited from
:class:`~repro_torch.core.dfc.DFCBase` unchanged; this module supplies the queue's
REDUCE/COMBINE (the queue analogue of Algorithm 2) over the simulated NVM.

Layout (queue analogue of Figure 1):
  NVM lines:
    'cEpoch'          {v}          global epoch counter (shared skeleton)
    'head'            {0, 1}       two alternating head pointers
    'tail'            {0, 1}       two alternating tail pointers
    ('valid', t), ('ann', t, s), ('pool', i)    as in the stack
  Volatile:
    cLock, rLock, enqList[N], deqList[N], vColl[N]

Combiner algorithm (one phase, lock held):
  1. REDUCE collects announced ops into enqList/deqList (lines 88-101 of the
     stack's pseudocode, shared via ``_collect``).
  2. Dequeues are served from the committed queue front; dequeued nodes are
     only *deallocated after the phase commits* — a queue phase can both
     allocate and free, and a node freed-then-reused before the epoch commit
     would corrupt the committed chain a crash rolls back to.
  3. When the queue drains, remaining dequeues PAIR with enqueues (the
     dequeue returns the enqueue's param directly; nothing touches the
     structure) — the queue's two-sided elimination.  A paired enq/deq is
     linearized as an adjacent enq;deq on the empty queue.
  4. Surplus enqueues build their chain back-to-front (each node line is
     written once, then pwb'd once) and are linked behind the committed tail.
     Writing the committed tail's ``next`` is crash-safe: traversal of the
     committed state is bounded by the committed (head, tail) pair, so a
     dangling link beyond the tail is unreachable after a rollback (recovery
     GC and ``snapshot`` stop at the tail for the same reason).
  5. The phase publishes by writing the *inactive* head/tail entries, pwb'ing
     responses + both pointer lines, and committing with the two-increment
     epoch protocol (shared ``_publish``).

Linearization witness of a combined batch: dequeues served from the queue
(FIFO order), then eliminated pairs (enq_k;deq_k adjacent), then surplus
enqueues in collection order; EMPTY dequeues linearize at the drained point.

Paper correspondence (arXiv:2012.12868; shared skeleton cites are in
``repro_torch.core.dfc``):
  * announce / valid / recovery:  Alg. 1 lines 2-12 and 26-43, inherited
    unchanged from :class:`~repro_torch.core.dfc.DFCBase`,
  * elimination rule: the queue analogue of Alg. 2 lines 102-110 — but
    TWO-SIDED and drain-gated: a deq may only pair with an enq once the
    committed queue is empty (pairing earlier would reorder FIFO),
  * one pfence per phase / two-increment ``cEpoch`` commit: Alg. 2 line 80
    and Alg. 1 lines 81-83, with the double-buffered root pair being
    (head, tail) instead of the stack's single ``top``,
  * deferred node reuse + bounded recovery GC walks: §4 — dequeued nodes
    are freed only after the epoch commits, and the recovery walk stops at
    the committed tail, so dangling links past it are unreachable.
"""

from __future__ import annotations

from typing import Any, Dict, Generator

from repro_torch.core.dfc import ACK, DEQ, EMPTY, ENQ, DFCBase
from repro_torch.nvm.pool import NIL


class DFCQueue(DFCBase):
    SEMANTICS = "queue"
    DRAIN_OP = DEQ

    def _alloc_structure(self) -> None:
        self.mem.alloc_line("head", **{"0": NIL, "1": NIL})
        self.mem.alloc_line("tail", **{"0": NIL, "1": NIL})

    def _extra_volatile(self) -> Dict[str, Any]:
        return dict(enqList=[0] * self.N, deqList=[0] * self.N)

    def _gc_roots(self):
        c_epoch = self.mem.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        head = self.mem.read("head", e)
        tail = self.mem.read("tail", e)
        return [head], [tail]

    def _route(self, i: int, op_name: str) -> None:
        if op_name == ENQ:
            self._n_enq += 1
            self.vol["enqList"][self._n_enq - 1] = i
        else:
            self._n_deq += 1
            self.vol["deqList"][self._n_deq - 1] = i

    # ---------------------------------------------------------------- Reduce
    def reduce(self, t: int) -> Generator:
        """Collect announced enq/deq ops; pairing is deferred to COMBINE
        because queue elimination is only legal once the queue has drained."""
        self._n_enq = self._n_deq = 0
        yield from self._collect(t)
        return self._n_enq, self._n_deq

    # --------------------------------------------------------------- Combine
    def combine(self, t: int) -> Generator:
        m = self.mem
        vol = self.vol
        n_enq, n_deq = yield from self.reduce(t)
        yield
        c_epoch = m.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        head = m.read("head", e)
        tail = m.read("tail", e)
        freed = []  # deallocated only after the phase commits (see docstring)
        ei = di = 0
        # ---- serve dequeues from the committed queue front ----------------
        while di < n_deq and head != NIL:
            c_id = vol["deqList"][di]
            v_op = vol["vColl"][c_id]
            yield
            m.write(("ann", c_id, v_op), "val", self.pool.param(head))
            freed.append(head)
            if head == tail:  # never follow next(tail): may dangle
                head = tail = NIL
            else:
                head = self.pool.next(head)
            di += 1
        # ---- queue drained: eliminate enq/deq pairs -----------------------
        while di < n_deq and ei < n_enq:
            c_deq = vol["deqList"][di]
            v_deq = vol["vColl"][c_deq]
            c_enq = vol["enqList"][ei]
            v_enq = vol["vColl"][c_enq]
            yield
            param = m.read(("ann", c_enq, v_enq), "param")
            m.write(("ann", c_deq, v_deq), "val", param)
            yield
            m.write(("ann", c_enq, v_enq), "val", ACK)
            di += 1
            ei += 1
            self.eliminated_pairs += 1
        # ---- dequeues beyond every enqueue: EMPTY -------------------------
        while di < n_deq:
            c_id = vol["deqList"][di]
            v_op = vol["vColl"][c_id]
            yield
            m.write(("ann", c_id, v_op), "val", EMPTY)
            di += 1
        # ---- surplus enqueues: build the appended chain back-to-front -----
        chain_head = NIL
        chain_tail = NIL
        j = n_enq - 1
        while j >= ei:
            c_id = vol["enqList"][j]
            v_op = vol["vColl"][c_id]
            yield
            param = m.read(("ann", c_id, v_op), "param")
            yield
            chain_head = self.pool.allocate(param, chain_head)
            if chain_tail == NIL:
                chain_tail = chain_head
            yield
            m.write(("ann", c_id, v_op), "val", ACK)
            yield
            m.pwb(t, self.pool.line_of(chain_head), tag="combine")
            j -= 1
        if chain_head != NIL:
            if tail == NIL:
                head = chain_head
            else:
                yield
                m.write(self.pool.line_of(tail), "next", chain_head)
                yield
                m.pwb(t, self.pool.line_of(tail), tag="combine")
            tail = chain_tail
        # ---- publish ------------------------------------------------------
        ne = self._next_top_entry(c_epoch)
        yield
        m.write("head", ne, head)
        yield
        m.write("tail", ne, tail)
        yield from self._publish(t, c_epoch, ("head", "tail"))
        for idx in freed:
            self.pool.deallocate(idx)

    # ------------------------------------------------------------ inspection
    def peek_queue(self):
        """Volatile view of the active queue, head first (test helper)."""
        c_epoch = self.mem.read("cEpoch", "v")
        e = self._top_entry(c_epoch)
        head = self.mem.read("head", e)
        tail = self.mem.read("tail", e)
        if head == NIL:
            return []
        return self.pool.walk(head, stop=tail)

    def snapshot(self):
        return self.peek_queue()
