"""Fabric flight recorder: ring-buffered structured event tracing with a
crash-durable tail.

A copy of the JAX package's ``obs/trace.py`` (framework-free; the port keeps
its own so that it imports nothing of that package).  Event payloads must
be plain Python ``int`` / ``float`` / ``str`` (or lists of them): the
sidecar is JSON, and a tensor or numpy scalar does not encode.

The paper's empirical story is a *schedule* — which pwbs and pfences ran, in
what order, attributed to which protocol step — and until now the repo could
only reconstruct it by arithmetic over counter totals.  The recorder makes
the schedule itself first-class: every instrumented site (announce, chain
dispatch, intent drain, pwb, pfence, epoch commit, reshard, recovery)
appends a structured event with a MONOTONIC sequence number to an in-memory
ring, and the tail of that ring is appended to a sidecar file
(``<root>/obs/trace.jsonl``) every time the fabric completes a pfence.

Durability model — and the invariant that makes tracing a correctness
feature rather than logging:

  * the recorder NEVER issues a persistence instruction of its own.  Events
    buffer in volatile memory; the flush to the sidecar file rides the
    fabric's own ``pfence`` completions (``SimFS.fsync`` calls
    ``on_pfence`` only after the fence succeeded, and the fault injector
    ticks BEFORE the hook), so pwb/pfence counts with tracing enabled are
    EXACTLY the untraced counts and the durable state is bit-identical
    (``tests/test_torch_obs.py`` holds the port to it);
  * a crash therefore leaves a durable trace PREFIX: every event recorded
    up to the last completed fence, none after it — the same prefix-point
    semantics the NVM lines themselves obey.  ``ShardedDFCRuntime.recover``
    EXTENDS that prefix with per-thread detectability verdicts, so the
    sidecar reads as a crash-forensics timeline: what the fabric was doing,
    where it died, and what recovery concluded about every announced op.

The recorder is opt-in: the default is :data:`NULL_RECORDER` (every method
a no-op, ``enabled`` False), so the hot path costs one attribute check.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

# ---------------------------------------------------------- event taxonomy
# One constant per instrumented protocol step; docs/observability.md is the
# prose companion.  Events are plain dicts: {"seq", "ts_us", "ev", ...}.
EV_TOPOLOGY = "topology"  # fabric shape: kinds, lanes, buckets
EV_ANNOUNCE = "announce"  # thread-side announcement (3 pwb + 2 pfence)
EV_DISPATCH = "dispatch"  # device combine dispatched for a chain/schedule
EV_DRAIN = "drain"  # host intent drain of one fused phase
EV_RETIRE = "retire"  # pipelined chain retired (persist + commit)
EV_PWB = "pwb"  # one persistent write-back (SimFS.write)
EV_PFENCE = "pfence"  # one persistence fence (SimFS.fsync)
EV_EPOCH = "epoch_commit"  # per-shard two-increment commit completed
EV_RESHARD = "reshard"  # split/merge transaction
EV_RECOVER = "recover"  # recovery pass begin/end
EV_VERDICT = "verdict"  # per-thread detectability verdict (recovery)
EV_SCHED = "sched"  # MultiThreadDriver interleaving action
EV_REQUEST = "request"  # serving-tier request lifecycle (arrive/admit/serve)
EV_FABRIC = "fabric"  # periodic per-shard gauge sample (backlog, epochs)


class NullRecorder:
    """The default recorder: every method a no-op.

    Instrumented code may call these unconditionally; sites that would pay
    to BUILD the event payload guard on ``enabled`` first.
    """

    enabled = False

    def event(self, ev: str, **fields: Any) -> None:
        return None

    @contextlib.contextmanager
    def span(self, ev: str, **fields: Any):
        yield None

    def on_pwb(self, rel: str, tag: Optional[str]) -> None:
        return None

    def on_pfence(self, rels, tag: Optional[str]) -> None:
        return None

    def flush(self) -> None:
        return None

    def events(self) -> List[Dict[str, Any]]:
        return []


NULL_RECORDER = NullRecorder()


class TraceRecorder(NullRecorder):
    """Ring-buffered event recorder with a pfence-riding durable tail.

    ``path`` is the sidecar file (``None`` keeps the trace memory-only —
    the ring still works, ``flush`` is a no-op).  ``capacity`` bounds the
    in-memory ring; the durable sidecar is append-only and unbounded (it is
    a forensics artifact, not runtime state — recovery never reads it).
    """

    enabled = True

    def __init__(self, path: Optional[Path] = None, capacity: int = 4096):
        self.path = Path(path) if path is not None else None
        self.capacity = int(capacity)
        self.seq = 0
        self.ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._pending: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter_ns()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if self.path.exists():
                # A prior incarnation (pre-crash run) left a durable prefix:
                # continue its sequence numbering so the sidecar reads as ONE
                # monotone timeline across the crash.
                lines = self.path.read_text().splitlines()
                for line in reversed(lines):
                    line = line.strip()
                    if line:
                        self.seq = int(json.loads(line).get("seq", -1)) + 1
                        break

    # ------------------------------------------------------------ recording
    def event(self, ev: str, **fields: Any) -> Dict[str, Any]:
        rec = {
            "seq": self.seq,
            "ts_us": (time.perf_counter_ns() - self._t0) / 1e3,
            "ev": ev,
        }
        rec.update(fields)
        self.seq += 1
        self.ring.append(rec)
        self._pending.append(rec)
        return rec

    @contextlib.contextmanager
    def span(self, ev: str, **fields: Any):
        """Record ``ev`` as ONE event carrying its wall duration (closed at
        exit, so the event's ``ts_us`` marks the END and ``dur_us`` spans
        back — the Chrome exporter re-bases it to a begin timestamp)."""
        t0 = time.perf_counter_ns()
        try:
            yield self
        finally:
            self.event(ev, dur_us=(time.perf_counter_ns() - t0) / 1e3, **fields)

    # -------------------------------------------------- persistence hooks
    def on_pwb(self, rel: str, tag: Optional[str]) -> None:
        self.event(EV_PWB, rel=rel, tag=tag or "untagged")

    def on_pfence(self, rels, tag: Optional[str]) -> None:
        """A fence COMPLETED: record it, then write the buffered tail to
        the sidecar.  Riding the fence (instead of fsyncing a trace file of
        our own) is what keeps tracing persistence-free; a crash loses
        exactly the events since the last fence — a durable prefix."""
        self.event(
            EV_PFENCE,
            n=(len(rels) if rels is not None else -1),
            tag=tag or "untagged",
        )
        self.flush()

    def flush(self) -> None:
        """Append the un-flushed tail to the sidecar file (host file I/O,
        not a fabric persistence op).  Called from ``on_pfence`` and from
        sanctioned host-side flush points (end of recovery, clean
        shutdown)."""
        if not self._pending:
            return
        if self.path is not None:
            with self.path.open("a") as f:
                for rec in self._pending:
                    f.write(json.dumps(rec) + "\n")
        self._pending.clear()

    # ------------------------------------------------------------- readback
    def events(self) -> List[Dict[str, Any]]:
        """The in-memory ring, oldest first (bounded by ``capacity``)."""
        return list(self.ring)


def read_trace(path) -> List[Dict[str, Any]]:
    """Load a trace sidecar file back into a list of event dicts."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def durable_digest(root, exclude: Iterable[str] = ("obs",)) -> str:
    """Content digest of everything DURABLE under ``root`` (the on-disk
    files — SimFS pending buffers are volatile by definition), excluding
    the observability sidecars.  The traced-vs-untraced parity gate hashes
    this: tracing must leave the durable state bit-identical."""
    root = Path(root)
    skip = tuple(exclude)
    h = hashlib.blake2b(digest_size=16)
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root).as_posix()
        if any(rel == s or rel.startswith(s + "/") for s in skip):
            continue
        h.update(rel.encode())
        h.update(b"\0")
        h.update(p.read_bytes())
        h.update(b"\1")
    return h.hexdigest()
