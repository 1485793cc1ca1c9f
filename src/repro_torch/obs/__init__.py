"""The disabled fabric observer (counterpart of the JAX package's ``obs``).

Only the null observer is ported in this slice: ``enabled`` is False and
``event``, the pwb/pfence hooks and the metrics registry are no-ops.  The
runtime and ``SimFS`` call them unconditionally (the per-leaf elision
counters, the epoch-commit event, the pwb/pfence hooks), so they must exist.
The flight recorder and the live metrics registry come with the
observability slice.
"""

from __future__ import annotations

from typing import Any, Optional

# event name of a per-shard epoch commit, as in the reference's obs/trace.py
EV_EPOCH = "epoch_commit"


class NullMetrics:
    """Metrics registry whose every method is a no-op."""

    def counter(self, name: str, delta: float = 1, **labels: Any) -> None:
        return None

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        return None


class NullObserver:
    """Disabled observer: the fabric-wide default.  One ``enabled`` check
    gates any instrumentation that would cost something to compute."""

    enabled = False

    def __init__(self):
        self.metrics = NullMetrics()

    def event(self, ev: str, **fields: Any) -> None:
        return None

    def on_pwb(self, rel: str, tag: Optional[str]) -> None:
        return None

    def on_pfence(self, rels, tag: Optional[str]) -> None:
        return None


NULL_OBS = NullObserver()
