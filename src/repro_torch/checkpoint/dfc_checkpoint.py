"""Simulated durable storage: ``SimFS``, ``FaultInjector``, ``CrashNow``.

Copies of the classes of the same names in the JAX package's
``checkpoint/dfc_checkpoint.py`` (that module imports JAX, so the port keeps
its own).  ``SimFS`` buffers writes in memory and puts them on disk only at
``fsync`` (pwb = write, pfence = fsync); a crash drops the unsynced buffers.
Every persistence op runs its hooks in the reference's order -- ``stats``,
then ``pstats``, then ``injector.tick``, then the durable work, then the
observer -- so a ``FaultInjector(crash_at=k)`` stops both packages at the
same op of the same schedule.  ``DFCCheckpointManager`` comes with the
training slice.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.nvm.memory import PersistStats
from repro_torch.obs import NULL_OBS


class CrashNow(Exception):
    """Raised by FaultInjector at the scheduled persistence op."""


@dataclasses.dataclass
class FaultInjector:
    """Crash at the k-th persistence operation (pwb or pfence)."""

    crash_at: Optional[int] = None
    count: int = 0

    def tick(self):
        self.count += 1
        if self.crash_at is not None and self.count >= self.crash_at:
            raise CrashNow(f"injected crash at persistence op {self.count}")


class SimFS:
    """Buffered filesystem: content reaches disk only at fsync (pwb=write,
    pfence=fsync).  Crash drops unsynced buffers.

    Persistence ops carry an optional attribution ``tag`` (announce, slot,
    resp, epoch, ...) counted into ``pstats``, a :class:`PersistStats`
    partitioning the ``stats`` totals by protocol step.
    """

    def __init__(self, root: Path, injector: Optional[FaultInjector] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.pending: Dict[str, bytes] = {}
        self.injector = injector or FaultInjector()
        self.stats = {"pwb": 0, "pfence": 0}
        self.pstats = PersistStats()
        self.obs = NULL_OBS

    def _p(self, rel: str) -> Path:
        return self.root / rel

    def write(self, rel: str, data: bytes, tag: Optional[str] = None) -> None:
        """pwb: buffered write — NOT durable until fsync."""
        self.stats["pwb"] += 1
        self.pstats.count_pwb(tag)
        self.injector.tick()
        self.pending[rel] = data
        self.obs.on_pwb(rel, tag)

    def fsync(self, rels: Optional[List[str]] = None, tag: Optional[str] = None) -> None:
        """pfence: flush pending writes to the real filesystem."""
        self.stats["pfence"] += 1
        self.pstats.count_pfence(tag)
        self.injector.tick()
        items = (
            list(self.pending.items())
            if rels is None
            else [(r, self.pending[r]) for r in rels if r in self.pending]
        )
        for rel, data in items:
            p = self._p(rel)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            self.pending.pop(rel, None)
        self.obs.on_pfence(rels, tag)

    def read(self, rel: str) -> Optional[bytes]:
        """Reads see the buffered (volatile) view, like a CPU cache."""
        if rel in self.pending:
            return self.pending[rel]
        p = self._p(rel)
        return p.read_bytes() if p.exists() else None

    def read_durable(self, rel: str) -> Optional[bytes]:
        p = self._p(rel)
        return p.read_bytes() if p.exists() else None

    def listdir(self, rel: str) -> List[str]:
        p = self._p(rel)
        disk = [f"{rel}/{x}" for x in os.listdir(p)] if p.exists() else []
        buf = [k for k in self.pending if k.startswith(rel + "/")]
        return sorted(set(disk) | set(buf))

    def delete(self, rel: str) -> None:
        self.pending.pop(rel, None)
        p = self._p(rel)
        if p.exists():
            p.unlink()

    def crash(self) -> "SimFS":
        """Lose all unsynced writes; return a fresh post-crash view."""
        return SimFS(self.root, FaultInjector())


BOT = None  # the paper's ⊥: an announcement whose response is not yet written
