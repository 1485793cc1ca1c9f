"""Simulated byte-addressable non-volatile memory (NVM).

Counterpart of the JAX package's ``nvm/memory.py``, copied so that the port
imports nothing of that package: the same persistency model, crash modes,
cache-line simulator and per-tag pwb/pfence counters.  It is plain Python;
no tensor lives here.

Implements the *explicit epoch persistency* model of Izraelevitz et al. [18]
assumed by the paper (Section 2):

  * Shared memory is split into non-volatile lines (NVM) and volatile state.
  * Program reads/writes hit the (volatile) cache.  A write reaches the
    persistence domain only via an explicit ``pwb`` (persistent write-back)
    followed by a ``pfence`` — or nondeterministically, when the cache line is
    evicted.
  * ``pwb`` ordering is NOT preserved across lines; a ``pfence`` orders and
    completes all preceding ``pwb`` s *of the issuing thread* (the paper notes
    that on x86 a pfence acts as pfence+psync, and we follow its convention of
    a combined pfence/psync).
  * Per-line, write-backs respect program order: the persisted value of a line
    is always some prefix-point of its write history.

A crash resets all volatile state and, for every line, picks a persisted
snapshot at least as new as the last fenced write-back and no newer than the
last write (arbitrary eviction).  ``CrashMode`` selects adversarial extremes
or randomized choice.

The simulator also keeps the persistence-instruction counters (pwb/pfence,
attributed to a *tag* such as ``announce`` vs ``combine``) that drive the
paper's Figures 3b/3c/3e/3f.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Hashable, List, Optional, Tuple

BOT = None  # the paper's ⊥


class CrashMode(enum.Enum):
    """How eagerly dirty lines are persisted at a crash."""

    MIN = "min"  # only fenced write-backs survive (most forgetful)
    MAX = "max"  # every write survives (most eager eviction)
    RANDOM = "random"  # uniformly random prefix-point per line, >= fenced


#: Tag bucket for persistence ops issued without an attribution tag, so the
#: tag dicts always partition the totals (nothing is silently untagged).
DEFAULT_TAG = "untagged"


@dataclasses.dataclass
class PersistStats:
    """pwb/pfence counters, attributed by tag.

    ``snapshot()``/``diff()`` give benchmarks and tests a windowed view
    (counts since a mark) without hand-rolled total arithmetic; untagged
    ops land in the :data:`DEFAULT_TAG` bucket.
    """

    pwb: Dict[str, int] = dataclasses.field(default_factory=dict)
    pfence: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count_pwb(self, tag: Optional[str] = None) -> None:
        tag = tag or DEFAULT_TAG
        self.pwb[tag] = self.pwb.get(tag, 0) + 1

    def count_pfence(self, tag: Optional[str] = None) -> None:
        tag = tag or DEFAULT_TAG
        self.pfence[tag] = self.pfence.get(tag, 0) + 1

    def total_pwb(self) -> int:
        return sum(self.pwb.values())

    def total_pfence(self) -> int:
        return sum(self.pfence.values())

    def snapshot(self) -> "PersistStats":
        """An immutable-by-convention copy of the current counters."""
        return PersistStats(pwb=dict(self.pwb), pfence=dict(self.pfence))

    def diff(self, since: "PersistStats") -> "PersistStats":
        """Counters accumulated since ``since`` (an earlier snapshot):
        per-tag subtraction, tags absent then treated as zero."""
        return PersistStats(
            pwb={
                t: n - since.pwb.get(t, 0)
                for t, n in self.pwb.items()
                if n != since.pwb.get(t, 0)
            },
            pfence={
                t: n - since.pfence.get(t, 0)
                for t, n in self.pfence.items()
                if n != since.pfence.get(t, 0)
            },
        )

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        """JSON-ready view (for result rows and metrics snapshots)."""
        return {"pwb": dict(self.pwb), "pfence": dict(self.pfence)}

    def clear(self) -> None:
        self.pwb.clear()
        self.pfence.clear()


class _Line:
    """One 64-byte cache line holding a dict of named fields.

    ``committed`` is the state in the persistence domain.  ``history`` holds a
    snapshot of the line after every volatile write since the last crash (or
    line creation); ``fenced`` is the history index guaranteed persisted.
    """

    __slots__ = ("committed", "history", "fenced", "cache")

    def __init__(self, init: Dict[str, Any]):
        self.committed: Dict[str, Any] = dict(init)
        self.cache: Dict[str, Any] = dict(init)
        self.history: List[Dict[str, Any]] = []
        self.fenced: int = 0


class NVMemory:
    """A collection of named NVM cache lines + persistence instructions."""

    def __init__(self, seed: int = 0):
        self._lines: Dict[Hashable, _Line] = {}
        # per-thread pending pwbs: tid -> list of (line_id, history_index)
        self._pending: Dict[Hashable, List[Tuple[Hashable, int]]] = {}
        self.stats = PersistStats()

    # ------------------------------------------------------------------ setup
    def alloc_line(self, line_id: Hashable, **fields: Any) -> None:
        if line_id in self._lines:
            raise ValueError(f"line {line_id!r} already allocated")
        self._lines[line_id] = _Line(fields)

    def has_line(self, line_id: Hashable) -> bool:
        return line_id in self._lines

    # ------------------------------------------------------------- primitives
    def read(self, line_id: Hashable, field: str) -> Any:
        return self._lines[line_id].cache[field]

    def write(self, line_id: Hashable, field: str, value: Any) -> None:
        line = self._lines[line_id]
        line.cache[field] = value
        line.history.append(dict(line.cache))

    def write_many(self, line_id: Hashable, **fields: Any) -> None:
        """Multiple same-line field writes as one snapshot (single store of a
        packed word, e.g. an announcement's (val, epoch) pair is still 2
        stores — use write() per field when store granularity matters)."""
        line = self._lines[line_id]
        line.cache.update(fields)
        line.history.append(dict(line.cache))

    def pwb(self, tid: Hashable, line_id: Hashable, tag: str = "other") -> None:
        """Enqueue a write-back of the line's *current* content (paper: pwb)."""
        line = self._lines[line_id]
        self._pending.setdefault(tid, []).append((line_id, len(line.history)))
        self.stats.count_pwb(tag)

    def pfence(self, tid: Hashable, tag: str = "other") -> None:
        """Order + complete all of ``tid``'s preceding pwbs (pfence+psync)."""
        for line_id, idx in self._pending.get(tid, ()):  # commit marks
            line = self._lines[line_id]
            line.fenced = max(line.fenced, idx)
        self._pending[tid] = []
        self.stats.count_pfence(tag)

    # ------------------------------------------------------------------ crash
    def crash(self, mode: CrashMode = CrashMode.MIN, rng=None) -> None:
        """System-wide crash-failure.

        Volatile caches are lost; every line's persisted value becomes some
        prefix-point of its write history that is at least the last fenced
        write-back (arbitrary eviction may have persisted more).
        """
        for line in self._lines.values():
            hi = len(line.history)
            lo = min(line.fenced, hi)
            if mode is CrashMode.MIN:
                pick = lo
            elif mode is CrashMode.MAX:
                pick = hi
            else:
                if rng is None:
                    raise ValueError("CrashMode.RANDOM requires rng")
                pick = int(rng.integers(lo, hi + 1)) if hi > lo else lo
            if pick > 0:
                line.committed = dict(line.history[pick - 1])
            # rebase: post-crash, cache == committed, history empty
            line.cache = dict(line.committed)
            line.history = []
            line.fenced = 0
        self._pending.clear()

    # ------------------------------------------------------------- inspection
    def persisted(self, line_id: Hashable, field: str) -> Any:
        """What would survive a MIN-mode crash right now (for tests)."""
        line = self._lines[line_id]
        if line.fenced > 0:
            return line.history[line.fenced - 1].get(field)
        return line.committed.get(field)
