"""Fabric observability: flight-recorder tracing + metrics registry.

Counterpart of the JAX package's ``obs`` package.  Entry point is
:class:`FabricObserver` (or the module-level :data:`NULL_OBS` default -- a
disabled observer whose every method is a no-op).  Construction is
decoupled from the runtime: an observer is handed to ``ShardedDFCRuntime`` /
``RequestQueueTier`` / ``SimFS`` by reference, never imported by them at
module level, so the ``obs`` package stays dependency-free (no ``torch``)
and the runtime works identically without it.

The one invariant everything here is built around: **observability never
adds a persistence instruction**.  Durable-state digests and pwb/pfence
counts with tracing enabled must equal the untraced run exactly; the trace
sidecar's durability rides the fabric's own pfences (see ``trace.py``).

``observe_fabric`` reads ``rt.shard_sizes()`` and ``rt.shard_epochs()``: on
the card each is a device-to-host copy, so the runtime samples only at the
reference's points (after a pipelined dispatch retires, after a fused
drain).  On a split-lane fabric it also samples ``rt.lane_stats()``: the
committed ``[eH, eT]`` pair and the per-lane backlog of each split shard.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

from .metrics import (
    Histogram,
    MetricsRegistry,
    NullMetrics,
    bridge_persist_stats,
    to_chrome_trace,
)
from .trace import (
    EV_ANNOUNCE,
    EV_DISPATCH,
    EV_DRAIN,
    EV_EPOCH,
    EV_FABRIC,
    EV_PFENCE,
    EV_PWB,
    EV_RECOVER,
    EV_REQUEST,
    EV_RESHARD,
    EV_RETIRE,
    EV_SCHED,
    EV_TOPOLOGY,
    EV_VERDICT,
    NULL_RECORDER,
    NullRecorder,
    TraceRecorder,
    durable_digest,
    read_trace,
)

__all__ = [
    "FabricObserver",
    "NullObserver",
    "NULL_OBS",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "MetricsRegistry",
    "NullMetrics",
    "Histogram",
    "bridge_persist_stats",
    "to_chrome_trace",
    "durable_digest",
    "read_trace",
    "EV_ANNOUNCE",
    "EV_DISPATCH",
    "EV_DRAIN",
    "EV_EPOCH",
    "EV_FABRIC",
    "EV_PFENCE",
    "EV_PWB",
    "EV_RECOVER",
    "EV_REQUEST",
    "EV_RESHARD",
    "EV_RETIRE",
    "EV_SCHED",
    "EV_TOPOLOGY",
    "EV_VERDICT",
]


class NullObserver:
    """Disabled observer: the fabric-wide default.  One ``enabled`` check
    gates any instrumentation that would cost something to compute."""

    enabled = False

    def __init__(self):
        self.trace = NULL_RECORDER
        self.metrics = NullMetrics()

    def event(self, ev: str, **fields: Any):
        return self.trace.event(ev, **fields)

    def span(self, ev: str, **fields: Any):
        return self.trace.span(ev, **fields)

    def on_pwb(self, rel: str, tag: Optional[str]) -> None:
        return None

    def on_pfence(self, rels, tag: Optional[str]) -> None:
        return None

    def flush(self) -> None:
        return None

    def observe_fabric(self, rt) -> None:
        return None


NULL_OBS = NullObserver()


class FabricObserver(NullObserver):
    """Live observer: a :class:`TraceRecorder` (optionally with a durable
    sidecar under ``<root>/obs/trace.jsonl``) plus a
    :class:`MetricsRegistry`, with the pwb/pfence hooks feeding both."""

    enabled = True

    def __init__(self, root=None, trace_capacity: int = 4096):
        self.root = Path(root) if root is not None else None
        path = self.root / "obs" / "trace.jsonl" if self.root is not None else None
        self.trace = TraceRecorder(path, capacity=trace_capacity)
        self.metrics = MetricsRegistry()

    @property
    def trace_path(self) -> Optional[Path]:
        return self.trace.path

    def on_pwb(self, rel: str, tag: Optional[str]) -> None:
        self.trace.on_pwb(rel, tag)
        self.metrics.counter("obs_pwb", tag=tag or "untagged")

    def on_pfence(self, rels, tag: Optional[str]) -> None:
        self.trace.on_pfence(rels, tag)
        self.metrics.counter("obs_pfence", tag=tag or "untagged")

    def flush(self) -> None:
        self.trace.flush()

    def observe_fabric(self, rt) -> None:
        """Sample per-shard gauges from a ``ShardedDFCRuntime`` (duck-typed
        — no runtime import).  Forces a device sync via ``shard_sizes``;
        call at phase boundaries, not per-op."""
        sizes = rt.shard_sizes()
        epochs = rt.shard_epochs()
        for s, size in enumerate(sizes):
            self.metrics.gauge("shard_backlog", int(size), shard=s, kind=rt.kinds[s])
            self.metrics.gauge("shard_epoch", int(epochs[s]), shard=s)
        inflight = len(getattr(rt, "_inflight", ()))
        self.metrics.gauge("inflight_chains", inflight)
        if getattr(rt, "ring", None) is not None:
            tail = int(getattr(rt, "_ring_tail", 0))
            spans = getattr(rt, "_ring_spans", {})
            head = min((s0 for s0, _ in spans.values()), default=tail)
            self.metrics.gauge("ring_occupancy", tail - head)
        # per-side combiners (split-lane fabrics): committed [eH, eT] pairs
        # and announced-but-uncombined backlog per (shard, lane)
        lane_stats = None
        getter = getattr(rt, "lane_stats", None)
        if callable(getter):
            lane_stats = getter()
        extra = {}
        if lane_stats:
            for s, pair in lane_stats.get("epochs", {}).items():
                self.metrics.gauge("lane_epoch_head", int(pair[0]), shard=s)
                self.metrics.gauge("lane_epoch_tail", int(pair[1]), shard=s)
            for s, bl in lane_stats.get("backlog", {}).items():
                self.metrics.gauge("lane_backlog_head", int(bl[0]), shard=s)
                self.metrics.gauge("lane_backlog_tail", int(bl[1]), shard=s)
            extra = {
                "lane_epochs": {
                    str(s): [int(e) for e in pair]
                    for s, pair in lane_stats.get("epochs", {}).items()
                },
                "lane_backlog": {
                    str(s): [int(x) for x in bl]
                    for s, bl in lane_stats.get("backlog", {}).items()
                },
            }
        self.event(
            EV_FABRIC,
            backlog=[int(x) for x in sizes],
            epochs=[int(e) for e in epochs],
            inflight=inflight,
            **extra,
        )
