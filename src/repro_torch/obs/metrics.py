"""Counter / gauge / histogram registry for the DFC fabric.

A copy of the JAX package's ``obs/metrics.py`` (framework-free; the port
keeps its own so that it imports nothing of that package).  The registry is
the queryable side of the flight recorder: where ``trace.py`` records *what
happened in order*, this module aggregates *how much and how fast* --
per-shard backlog and ring-occupancy gauges, pwb/op and pfence/phase
counters fed from :class:`repro_torch.nvm.memory.PersistStats`, elision hit
rates, in-flight chain depth, and log-bucketed latency histograms with
p50/p99 readout.  Everything lives in volatile host memory: metrics are
derived state and are never persisted through the fabric (the same
never-add-a-persistence-instruction constraint the recorder obeys).

Recorded values must be plain Python numbers: cast a tensor or numpy
scalar at the call site, or ``to_jsonl`` cannot encode it.

Exporters: :meth:`MetricsRegistry.to_jsonl` (one metric per line, easy to
diff/grep) and :func:`to_chrome_trace` (renders a recorded event list as a
``chrome://tracing`` / Perfetto-loadable JSON array).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

# Quarter-power-of-two buckets: ~19% relative width, 4 buckets per octave.
# Fine enough that p50/p99 are honest, coarse enough that a histogram is a
# handful of ints.
_BASE = 2.0 ** 0.25
_LN_BASE = math.log(_BASE)


class Histogram:
    """Log-bucketed histogram (quarter-octave buckets) with percentile
    readout.  Values must be non-negative; zeros land in a dedicated
    underflow bucket so latency-0 samples (same-tick admission) don't
    poison the log scale."""

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0:
            v = 0.0
        idx = -(2 ** 31) if v == 0 else int(math.floor(math.log(v) / _LN_BASE))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]: the geometric midpoint of the
        bucket holding the q-th sample, clamped to the observed min/max."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen > rank:
                if idx == -(2 ** 31):
                    return 0.0
                mid = _BASE ** (idx + 0.5)
                lo = 0.0 if self.min is None else self.min
                hi = mid if self.max is None else self.max
                return max(lo, min(mid, hi))
        return self.max or 0.0

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min or 0.0,
            "max": self.max or 0.0,
            "p50": self.p50,
            "p99": self.p99,
        }


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Flat registry keyed by ``name{label=value,...}`` strings.

    Counters are monotone adds (or absolute sets via ``counter_set`` for
    mirroring an external monotone source like ``PersistStats``); gauges
    are last-write-wins; histograms accumulate samples.
    """

    enabled = True

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------------ recording
    def counter(self, name: str, delta: float = 1, **labels: Any) -> None:
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + delta

    def counter_set(self, name: str, value: float, **labels: Any) -> None:
        self.counters[_key(name, labels)] = value

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        self.gauges[_key(name, labels)] = value

    def histogram(self, name: str, **labels: Any) -> Histogram:
        k = _key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = Histogram()
        return h

    def observe(self, name: str, value: float, **labels: Any) -> None:
        self.histogram(name, **labels).record(value)

    # ------------------------------------------------------------- readback
    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.histograms.items()},
        }

    def to_jsonl(self, path) -> int:
        """Write one JSON line per metric; returns the line count."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        lines = []
        for k, v in sorted(self.counters.items()):
            lines.append({"type": "counter", "name": k, "value": v})
        for k, v in sorted(self.gauges.items()):
            lines.append({"type": "gauge", "name": k, "value": v})
        for k, h in sorted(self.histograms.items()):
            lines.append({"type": "histogram", "name": k, **h.summary()})
        with p.open("w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
        return len(lines)


class NullMetrics(MetricsRegistry):
    """Registry that drops everything — the disabled-observer default, so
    unguarded ``obs.metrics.counter(...)`` calls stay safe and O(1)."""

    enabled = False

    def counter(self, name, delta=1, **labels):
        return None

    def counter_set(self, name, value, **labels):
        return None

    def gauge(self, name, value, **labels):
        return None

    def observe(self, name, value, **labels):
        return None


def bridge_persist_stats(registry: MetricsRegistry, pstats, prefix: str = "persist") -> None:
    """Mirror a :class:`PersistStats` tag dict into the registry as absolute
    counters (``persist_pwb{tag=...}`` / ``persist_pfence{tag=...}``) plus
    totals.  Call at phase boundaries; PersistStats stays the source of
    truth, the registry is the queryable projection."""
    for tag, n in pstats.pwb.items():
        registry.counter_set(f"{prefix}_pwb", n, tag=tag)
    for tag, n in pstats.pfence.items():
        registry.counter_set(f"{prefix}_pfence", n, tag=tag)
    registry.counter_set(f"{prefix}_pwb_total", pstats.total_pwb())
    registry.counter_set(f"{prefix}_pfence_total", pstats.total_pfence())


def to_chrome_trace(events: List[Dict[str, Any]], path) -> int:
    """Render recorded trace events as a Chrome trace-event JSON array
    (load in chrome://tracing or ui.perfetto.dev).  Events with ``dur_us``
    become complete ('X') slices re-based to their begin time; the rest
    become instants ('i').  Returns the event count."""
    out = []
    for e in events:
        ts = float(e.get("ts_us", 0.0))
        dur = e.get("dur_us")
        rec = {
            "name": e.get("ev", "?"),
            "pid": 0,
            "tid": int(e.get("thread", 0)),
            "args": {
                k: v
                for k, v in e.items()
                if k not in ("ev", "ts_us", "dur_us", "thread")
            },
        }
        if dur is not None:
            rec.update(ph="X", ts=ts - float(dur), dur=float(dur))
        else:
            rec.update(ph="i", ts=ts, s="t")
        out.append(rec)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1) + "\n")
    return len(out)
