"""DFC — the paper's detectable flat-combining persistent stack (Algorithms 1-2).

Counterpart of the JAX package's ``core/dfc.py``: the same line-by-line
reproduction over the simulated NVM (`repro_torch.nvm`), plain Python.  Each
``yield`` is one atomic shared-memory step for the cooperative scheduler, so
crash points can be injected between any two steps.

Layout (Figure 1):
  NVM lines:
    'cEpoch'          {v}                    global epoch counter
    'top'             {0, 1}                 two alternating head pointers
    ('valid', t)      {v}                    2-bit valid (MSB<<1 | LSB)
    ('ann', t, s)     {val, epoch, param, name}   s ∈ {0,1} — one cache line,
                       so val+epoch persist together (the paper relies on this)
    ('pool', i)       {param, next}          pre-allocated node pool (§4)
  Volatile:
    cLock, rLock, pushList[N], popList[N], vColl[N]

The announce / lock hand-off / recovery skeleton (Algorithm 1) is shared by
all three of the paper's structures — stack, FIFO queue (`dfc_queue`), and
double-ended queue (`dfc_deque`) — via :class:`DFCBase`; only REDUCE/COMBINE
(Algorithm 2) and the double-buffered root pointers differ per structure.

Paper correspondence (mechanism -> pseudocode of arXiv:2012.12868):
  * announce + publish:        Alg. 1 lines 2-12 (double-buffered ``ann``,
                               2-bit ``valid``: LSB pfenced, MSB bare)
  * combiner lock hand-off:    Alg. 1 (``cLock`` try-lock; losers spin on
                               their response, then help-check)
  * REDUCE + elimination:      Alg. 2 (collection lines 88-101; push/pop
                               pair matching lines 102-110 — eliminated
                               pairs never touch the persistent structure)
  * one pfence per phase:      Alg. 2 line 80 (responses + new state drain
                               under a single barrier)
  * two-increment epoch:       Alg. 1 lines 81-83 — pwb+pfence ``cEpoch=v+1``
                               then write ``v+2`` WITHOUT a fence; parity
                               selects the live ``top`` entry
  * recovery + verdicts:       Alg. 1 lines 26-43 (round odd epoch up,
                               re-publish half-written ``valid`` selectors,
                               re-execute ops of the crashed phase,
                               per-thread detectability verdicts)
  * node reclamation / GC:     §4 (volatile free-bitmap rebuilt by a
                               recovery walk bounded by the committed roots)

Deviations from the pseudocode (documented):
  * Initial announcements get ``epoch=-1, val=INIT, name=NONE`` instead of
    all-zero, so that threads which never announced an operation are not
    mistaken for pending ops by Recover/Reduce.  The paper's benchmarks never
    exercise this corner (every thread always has an op in flight).
  * ``LSB/MSB(valid)`` are bit ops on a small int, as the paper suggests.
"""

from __future__ import annotations

from typing import Any, Dict, Generator, Iterable, Optional, Sequence, Tuple

from repro_torch.nvm.memory import BOT, NVMemory
from repro_torch.nvm.pool import NIL, NodePool

PUSH = "push"
POP = "pop"
ENQ = "enq"  # FIFO queue (repro_torch.core.dfc_queue)
DEQ = "deq"
PUSHL = "pushL"  # double-ended queue (repro_torch.core.dfc_deque)
POPL = "popL"
PUSHR = "pushR"
POPR = "popR"
NONE = "none"
ACK = "ACK"
EMPTY = "EMPTY"
INIT = "INIT"  # val of a never-used announcement slot


class DFCBase:
    """Algorithm 1 (announce, lock hand-off, try-to-return, recover) — the
    structure-independent detectable flat-combining skeleton.

    Subclasses provide:
      * ``SEMANTICS``  — key into ``repro_torch.core.linearize.SEMANTICS``
      * ``DRAIN_OP``   — op name that removes one element (harness drains)
      * ``_alloc_structure()``   — allocate the double-buffered root lines
      * ``_extra_volatile()``    — combiner scratch lists
      * ``_gc_roots()``          — (roots, stops) for the recovery GC cycle
      * ``combine(t)``           — Algorithm 2 for the concrete structure
      * ``snapshot()``           — current contents (test/drain helper)
    """

    SEMANTICS = "stack"
    DRAIN_OP = POP
    POOL_EXTRA_FIELDS: Tuple[str, ...] = ()

    def __init__(self, mem: NVMemory, n_threads: int, pool_capacity: int = 4096):
        self.mem = mem
        self.N = n_threads
        self.pool = NodePool(
            mem, pool_capacity, extra_fields=self.POOL_EXTRA_FIELDS
        )
        mem.alloc_line("cEpoch", v=0)
        self._alloc_structure()
        for t in range(n_threads):
            mem.alloc_line(("valid", t), v=0)
            for s in (0, 1):
                mem.alloc_line(("ann", t, s), val=INIT, epoch=-1, param=BOT, name=NONE)
        self.vol: Dict[str, Any] = {}
        self.reset_volatile()
        self.phases = 0  # combining-phase counter (Figure 4)
        self.eliminated_pairs = 0  # op pairs resolved without structure access
        self.combined_ops = 0  # total ops collected by combiners

    # ----------------------------------------------------------------- hooks
    def _alloc_structure(self) -> None:
        raise NotImplementedError

    def _extra_volatile(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _gc_roots(self) -> Tuple[Sequence[int], Iterable[int]]:
        raise NotImplementedError

    def combine(self, t: int) -> Generator:
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError

    # ----------------------------------------------------------------- state
    def reset_volatile(self) -> None:
        """Crash: all volatile shared variables return to initial values."""
        self.vol = dict(
            cLock=0,
            rLock=0,
            vColl=[BOT] * self.N,
            **self._extra_volatile(),
        )

    def _top_entry(self, epoch: int) -> str:
        return str((epoch // 2) % 2)

    def _next_top_entry(self, epoch: int) -> str:
        return str((epoch // 2 + 1) % 2)

    # ------------------------------------------------------------------- Op
    def op(self, t: int, name: str, param: Any = None) -> Generator:
        """Algorithm 1, lines 1-18."""
        m = self.mem
        yield
        op_epoch = m.read("cEpoch", "v")  # L2
        if op_epoch % 2 == 1:  # L3
            op_epoch += 1
        yield
        n_op = 1 - (m.read(("valid", t), "v") & 1)  # L4
        ann = ("ann", t, n_op)
        yield
        m.write(ann, "val", BOT)  # L5
        yield
        m.write(ann, "epoch", op_epoch)  # L6
        yield
        m.write(ann, "param", param)  # L7
        yield
        m.write(ann, "name", name)  # L8
        yield
        m.pwb(t, ann, tag="announce")  # L9
        yield
        m.pfence(t, tag="announce")
        yield
        m.write(("valid", t), "v", n_op)  # L10 (MSB=0, LSB=n_op)
        yield
        m.pwb(t, ("valid", t), tag="announce")  # L11
        yield
        m.pfence(t, tag="announce")
        yield
        m.write(("valid", t), "v", 2 | n_op)  # L12 (MSB=1)
        value = yield from self.take_lock(t, op_epoch)  # L13
        if value is not BOT:  # L14
            return value  # L15
        yield from self.combine(t)  # L17
        yield
        return m.read(ann, "val")  # L18

    # -------------------------------------------------------------- TakeLock
    def take_lock(self, t: int, op_epoch: int) -> Generator:
        """Algorithm 1, lines 19-25."""
        m = self.mem
        yield
        if self.vol["cLock"] == 0:  # L20: CAS(0,1)
            self.vol["cLock"] = 1
            return BOT  # L25: caller becomes the combiner
        while True:  # L21
            yield
            if not (m.read("cEpoch", "v") <= op_epoch + 1):
                break
            yield
            if self.vol["cLock"] == 0 and m.read("cEpoch", "v") <= op_epoch + 1:  # L22
                return (yield from self.take_lock(t, op_epoch))  # L23
        return (yield from self.try_to_return(t, op_epoch))  # L24

    # ----------------------------------------------------------- TryToReturn
    def try_to_return(self, t: int, op_epoch: int) -> Generator:
        """Algorithm 1, lines 44-50."""
        m = self.mem
        yield
        v_op = m.read(("valid", t), "v") & 1  # L45
        yield
        val = m.read(("ann", t, v_op), "val")  # L46
        if val is BOT:  # L47: late arrival
            op_epoch += 2  # L48
            return (yield from self.take_lock(t, op_epoch))  # L49
        return val  # L50

    # ------------------------------------------------------ announcement scan
    def _collect(self, t: int) -> Generator:
        """Algorithm 2, lines 88-101 (shared collection loop of REDUCE).

        Scans the announcement array, stamps collected ops with the current
        epoch (val+epoch share the cache line, so they persist together) and
        fills ``vColl``.  Yields (i, op_name) for each collected op; the
        caller routes it into its per-structure lists.
        """
        m = self.mem
        vol = self.vol
        yield
        c_epoch = m.read("cEpoch", "v")
        for i in range(self.N):  # L88
            yield
            v_op = m.read(("valid", i), "v")  # L89
            lsb = v_op & 1
            ann = ("ann", i, lsb)
            yield
            op_val = m.read(ann, "val")  # L90
            yield
            op_name = m.read(ann, "name")
            if (v_op >> 1) & 1 == 1 and op_val is BOT and op_name != NONE:  # L91
                yield
                m.write(ann, "epoch", c_epoch)  # L92 (val+epoch share the line)
                vol["vColl"][i] = lsb  # L93
                self.combined_ops += 1
                self._route(i, op_name)  # L94-99
            else:
                vol["vColl"][i] = BOT  # L101

    def _route(self, i: int, op_name: str) -> None:
        """Place collected op ``i`` into the combiner's scratch lists."""
        raise NotImplementedError

    # --------------------------------------------------------------- publish
    def _publish(self, t: int, c_epoch: int, struct_lines: Sequence) -> Generator:
        """Algorithm 2, lines 77-85: persist responses + roots, then commit
        the phase with the two-increment epoch protocol."""
        m = self.mem
        vol = self.vol
        for i in range(self.N):  # L77
            v_op = vol["vColl"][i]  # L78
            if v_op is not BOT:  # L79
                yield
                m.pwb(t, ("ann", i, v_op), tag="combine")
        for line in struct_lines:
            yield
            m.pwb(t, line, tag="combine")  # L80
        yield
        m.pfence(t, tag="combine")
        yield
        m.write("cEpoch", "v", c_epoch + 1)  # L81
        yield
        m.pwb(t, "cEpoch", tag="combine")  # L82
        yield
        m.pfence(t, tag="combine")
        yield
        m.write("cEpoch", "v", c_epoch + 2)  # L83
        yield
        self.vol["cLock"] = 0  # L84
        self.phases += 1

    # --------------------------------------------------------------- Recover
    def recover(self, t: int) -> Generator:
        """Algorithm 1, lines 26-43."""
        m = self.mem
        yield
        if self.vol["rLock"] == 0:  # L27: rLock.CAS(0,1)
            self.vol["rLock"] = 1
            yield
            c_epoch = m.read("cEpoch", "v")
            if c_epoch % 2 == 1:  # L28
                c_epoch += 1
                yield
                m.write("cEpoch", "v", c_epoch)  # L29
                yield
                m.pwb(t, "cEpoch", tag="recover")  # L30
                yield
                m.pfence(t, tag="recover")
            yield
            roots, stops = self._gc_roots()
            self.pool.garbage_collect(roots, stops=stops)  # L31
            for i in range(self.N):  # L32
                yield
                v_op = m.read(("valid", i), "v")  # L33
                lsb = v_op & 1
                yield
                op_epoch = m.read(("ann", i, lsb), "epoch")  # L34
                if (v_op >> 1) & 1 == 0:  # L35
                    yield
                    m.write(("valid", i), "v", 2 | lsb)  # L36
                if op_epoch == c_epoch:  # L37
                    yield
                    m.write(("ann", i, lsb), "val", BOT)  # L38
            yield from self.combine(t)  # L39
            yield
            self.vol["rLock"] = 2  # L40
        else:
            while True:  # L42
                yield
                if self.vol["rLock"] != 1:
                    break
        yield
        lsb = m.read(("valid", t), "v") & 1
        return m.read(("ann", t, lsb), "val")  # L43

    # ------------------------------------------------------------ inspection
    def active_announcement(self, t: int):
        """(name, param, val) of thread t's active announcement (helper)."""
        lsb = self.mem.read(("valid", t), "v") & 1
        ann = ("ann", t, lsb)
        return (
            self.mem.read(ann, "name"),
            self.mem.read(ann, "param"),
            self.mem.read(ann, "val"),
        )


class DFCStack(DFCBase):
    """The paper's detectable FC stack (Algorithm 2 as published)."""

    SEMANTICS = "stack"
    DRAIN_OP = POP

    def _alloc_structure(self) -> None:
        self.mem.alloc_line("top", **{"0": NIL, "1": NIL})

    def _extra_volatile(self) -> Dict[str, Any]:
        return dict(pushList=[0] * self.N, popList=[0] * self.N)

    def _gc_roots(self):
        c_epoch = self.mem.read("cEpoch", "v")
        return [self.mem.read("top", self._top_entry(c_epoch))], ()

    def _route(self, i: int, op_name: str) -> None:
        vol = self.vol
        if op_name == PUSH:  # L94
            self._t_push += 1  # L95
            vol["pushList"][self._t_push] = i  # L96
        else:
            self._t_pop += 1  # L98
            vol["popList"][self._t_pop] = i  # L99

    # ---------------------------------------------------------------- Reduce
    def reduce(self, t: int) -> Generator:
        """Algorithm 2, lines 86-113 (push/pop pair elimination)."""
        m = self.mem
        vol = self.vol
        self._t_push = self._t_pop = -1  # L87
        yield from self._collect(t)  # L88-101
        t_push, t_pop = self._t_push, self._t_pop
        while t_push != -1 and t_pop != -1:  # L102: eliminate pairs
            c_push = vol["pushList"][t_push]  # L103
            c_pop = vol["popList"][t_pop]  # L104
            v_push = vol["vColl"][c_push]  # L105
            yield
            m.write(("ann", c_push, v_push), "val", ACK)  # L106
            v_pop = vol["vColl"][c_pop]  # L107
            yield
            param = m.read(("ann", c_push, v_push), "param")
            m.write(("ann", c_pop, v_pop), "val", param)  # L108
            t_push -= 1  # L109
            t_pop -= 1  # L110
            self.eliminated_pairs += 1
        if t_push != -1:
            return t_push + 1  # L111: surplus pushes
        if t_pop != -1:
            return -(t_pop + 1)  # L112: surplus pops
        return 0  # L113

    # --------------------------------------------------------------- Combine
    def combine(self, t: int) -> Generator:
        """Algorithm 2, lines 51-85 (runs with the combiner lock held)."""
        m = self.mem
        vol = self.vol
        t_index = yield from self.reduce(t)  # L52
        yield
        c_epoch = m.read("cEpoch", "v")
        head = m.read("top", self._top_entry(c_epoch))  # L53
        if t_index > 0:  # L54: surplus pushes
            while t_index > 0:  # L55
                t_index -= 1  # L56
                c_id = vol["pushList"][t_index]  # L57
                v_op = vol["vColl"][c_id]  # L58
                yield
                param = m.read(("ann", c_id, v_op), "param")  # L59
                yield
                n_node = self.pool.allocate(param, head)  # L60
                yield
                m.write(("ann", c_id, v_op), "val", ACK)  # L61
                yield
                m.pwb(t, self.pool.line_of(n_node), tag="combine")  # L62
                head = n_node  # L63
        elif t_index < 0:  # L64: surplus pops
            t_index = -t_index  # L65
            while t_index > 0:  # L66
                t_index -= 1  # L67
                c_id = vol["popList"][t_index]  # L68
                v_op = vol["vColl"][c_id]  # L69
                if head == NIL:  # L70
                    yield
                    m.write(("ann", c_id, v_op), "val", EMPTY)  # L71
                else:
                    yield
                    m.write(("ann", c_id, v_op), "val", self.pool.param(head))  # L73
                    temp_head = head  # L74
                    head = self.pool.next(head)
                    self.pool.deallocate(temp_head)  # L75
        yield
        m.write("top", self._next_top_entry(c_epoch), head)  # L76
        yield from self._publish(t, c_epoch, ("top",))  # L77-85

    # ------------------------------------------------------------ inspection
    def peek_stack(self):
        """Volatile view of the active stack (test helper)."""
        c_epoch = self.mem.read("cEpoch", "v")
        head = self.mem.read("top", self._top_entry(c_epoch))
        return self.pool.walk(head)

    def snapshot(self):
        return self.peek_stack()
