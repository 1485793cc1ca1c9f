"""Persistent node pool with a volatile bitmap-tree allocator (paper §4);
counterpart of the JAX package's ``nvm/pool.py``.

All nodes live in a pre-allocated NVM region.  Which nodes are free/used is
tracked *only in volatile memory* by a two-level bitmap: 64 leaf words of 64
bits each (4096 nodes per level-1 group, extended with more groups as needed)
plus a root word marking which leaf words still have free bits.  On recovery,
a garbage-collection cycle rebuilds the bitmap by marking every node reachable
from the active ``top`` entry as used and everything else as free — so the
allocator metadata never needs persistence instructions (the paper's
"lightweight in normal operation, more expensive recovery" trade-off).

A node occupies one cache line holding (param, next).
"""

from __future__ import annotations

from typing import Hashable, Iterable, List, Optional

from repro_torch.nvm.memory import BOT, NVMemory

WORD_BITS = 64
NIL = -1  # encoding of a ⊥ next-pointer / empty top


class BitmapTree:
    """Volatile two-level (root + leaves) free-list bitmap. Bit set = used."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        n_words = (capacity + WORD_BITS - 1) // WORD_BITS
        self.leaves: List[int] = [0] * n_words
        # root bit i set  <=>  leaf word i is completely full
        self.root = 0
        # mark the padding tail of the last word as used so it is never handed out
        tail = n_words * WORD_BITS - capacity
        if tail:
            self.leaves[-1] = ((1 << tail) - 1) << (WORD_BITS - tail)

    def alloc(self) -> int:
        for w, word in enumerate(self.leaves):
            if not (self.root >> w) & 1:
                free = ~word & ((1 << WORD_BITS) - 1)
                b = (free & -free).bit_length() - 1
                self.leaves[w] = word | (1 << b)
                if self.leaves[w] == (1 << WORD_BITS) - 1:
                    self.root |= 1 << w
                idx = w * WORD_BITS + b
                if idx >= self.capacity:
                    raise MemoryError("node pool exhausted")
                return idx
        raise MemoryError("node pool exhausted")

    def free(self, idx: int) -> None:
        w, b = divmod(idx, WORD_BITS)
        self.leaves[w] &= ~(1 << b)
        self.root &= ~(1 << w)

    def is_used(self, idx: int) -> bool:
        w, b = divmod(idx, WORD_BITS)
        return bool((self.leaves[w] >> b) & 1)

    def clear(self) -> None:
        self.__init__(self.capacity)

    def used_count(self) -> int:
        full = sum(bin(w).count("1") for w in self.leaves)
        tail = len(self.leaves) * WORD_BITS - self.capacity
        return full - tail


class NodePool:
    """NVM-resident node pool managed by a volatile :class:`BitmapTree`.

    ``extra_fields`` adds named pointer fields beyond ``next`` to every node
    line (the deque's doubly-linked nodes carry a ``prev``); a node still
    occupies a single cache line, so one pwb persists all of its fields.
    """

    def __init__(
        self,
        mem: NVMemory,
        capacity: int = 4096,
        name: str = "pool",
        extra_fields: tuple = (),
    ):
        self.mem = mem
        self.capacity = capacity
        self.name = name
        self.extra_fields = tuple(extra_fields)
        self.bitmap = BitmapTree(capacity)
        extras = {f: NIL for f in self.extra_fields}
        for i in range(capacity):
            mem.alloc_line(self._line(i), param=BOT, next=NIL, **extras)

    def _line(self, idx: int) -> Hashable:
        return (self.name, idx)

    # ------------------------------------------------------------ allocation
    def allocate(self, param, nxt: int, **extras) -> int:
        """AllocateNode(param, head): volatile bitmap claim + node field writes.

        The *caller* is responsible for pwb'ing the node line (paper line 62).
        """
        idx = self.bitmap.alloc()
        self.mem.write(self._line(idx), "param", param)
        self.mem.write(self._line(idx), "next", nxt)
        for f, v in extras.items():
            self.mem.write(self._line(idx), f, v)
        return idx

    def deallocate(self, idx: int) -> None:
        """DeallocateNode: volatile-only bit reset — no persistence needed."""
        self.bitmap.free(idx)

    # --------------------------------------------------------------- access
    def param(self, idx: int):
        return self.mem.read(self._line(idx), "param")

    def next(self, idx: int) -> int:
        return self.mem.read(self._line(idx), "next")

    def get(self, idx: int, field: str):
        return self.mem.read(self._line(idx), field)

    def set(self, idx: int, field: str, value) -> None:
        self.mem.write(self._line(idx), field, value)

    def line_of(self, idx: int) -> Hashable:
        return self._line(idx)

    # ------------------------------------------------------------------- GC
    def garbage_collect(self, roots: Iterable[int], stops: Iterable[int] = ()) -> int:
        """Recovery GC cycle (paper §4): rebuild the volatile bitmap by
        marking the nodes reachable from ``roots`` (the active top) used and
        everything else free.  Runs single-threaded under the recovery lock.

        ``stops`` bounds each walk: a node in ``stops`` is marked live but its
        ``next`` is not followed.  The queue/deque need this — the committed
        tail's ``next`` may hold a dangling link written by a combine phase
        that never published.

        Returns the number of live nodes."""
        self.bitmap.clear()
        stop_set = set(stops)
        live = 0
        for root in roots:
            idx = root
            while idx != NIL and idx is not BOT:
                if self.bitmap.is_used(idx):  # shared tail already marked
                    break
                w, b = divmod(idx, WORD_BITS)
                self.bitmap.leaves[w] |= 1 << b
                if self.bitmap.leaves[w] == (1 << WORD_BITS) - 1:
                    self.bitmap.root |= 1 << w
                live += 1
                if idx in stop_set:
                    break
                idx = self.next(idx)
        return live

    def walk(self, head: int, stop: Optional[int] = None) -> List:
        """Return [param, ...] from head following ``next`` (test helper).

        ``stop`` (inclusive) bounds the walk the same way GC ``stops`` do —
        required when walking a queue/deque whose committed tail may carry a
        stale ``next``."""
        out = []
        idx = head
        while idx != NIL and idx is not BOT:
            out.append(self.param(idx))
            if stop is not None and idx == stop:
                break
            idx = self.next(idx)
        return out
