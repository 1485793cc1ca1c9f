"""The port's flight recorder against the JAX package's, on the CPU.

Tracing is a pure observer of the durable path: with a ``FabricObserver``
attached, the port's durable root (``durable_digest``), its pwb/pfence
counts per tag and its results equal the untraced run's, on the fused
phase loop, the pipelined path, the ``MultiThreadDriver``, every third crash
point of the fused drain and the serving tier.  The same schedule through
both packages gives the same durable digest, the same per-tag counts and
the same event sequence (``pwb``, ``pfence``, ``epoch_commit``,
``announce``, ``dispatch``, ``retire``, ``drain``, ``fabric``, ``recover``,
``verdict``, ``sched`` and ``request`` events) once the timing fields
``ts_us`` / ``dur_us`` are dropped.  Recovery continues the sidecar's
``seq``; the histogram, the registry and the Chrome exporter give the
reference's output on the same inputs; ``tools/fabric_top.py`` renders a
trace the port wrote.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.launch import serve as JV  # noqa: E402
from repro.runtime import announce_driver as JD  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.runtime import announce_driver as TD  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
CAP, LANES = 256, 16
KINDS = ["queue", "stack", "deque", "map"]
# package -> (obs, checkpoint, runtime, announce_driver, serve, runtime keyword args)
PKGS = {
    "jax": (JO, JC, JS, JD, JV, {}),
    "torch": (TO, TC, TS, TD, TV, {"device": "cpu"}),
}
TIMING = ("ts_us", "dur_us")


def _schedule(n_rounds, n_threads, per_thread, seed=11):
    """Flat schedule with globally unique params, round-major: ``(thread,
    token, keys, ops, params)``; op 1 is a push / enqueue / insert in every
    kind."""
    rng = np.random.default_rng(seed)
    val = 1.0
    sched = []
    for r in range(n_rounds):
        for t in range(n_threads):
            keys = [int(k) for k in rng.integers(0, 1000, per_thread)]
            params = [val + i for i in range(per_thread)]
            val += per_thread
            sched.append((t, r + 1, keys, [1] * per_thread, params))
    return sched


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in TIMING} for e in events]


def _fabric(pkg, root, *, n_threads, obs=None, crash_at=None, **kw):
    o, ck, rt_mod, _, _, dev = PKGS[pkg]
    fs = ck.SimFS(root, ck.FaultInjector(crash_at=crash_at))
    rt = rt_mod.ShardedDFCRuntime(KINDS, 4, CAP, LANES, fs=fs, n_threads=n_threads,
                                  obs=obs, **kw, **dev)
    return fs, rt


def _drive(pkg, path, root, obs=None):
    """One schedule through ``pkg``'s fabric on ``path``: ``fused`` (the
    phase loop), ``pipelined`` (depth 2, announce + combine per batch) or
    ``multithread`` (the seeded ``MultiThreadDriver`` at depth 3, chain 2).
    Returns (fs, rt, per-batch responses)."""
    sched = _schedule(3, 2, 4, seed={"fused": 11, "pipelined": 5, "multithread": 3}[path])
    if path == "fused":
        fs, rt = _fabric(pkg, root, n_threads=2, obs=obs)
        recs = rt.phase_loop(sched)
        return fs, rt, [(r["resp"], r["kinds"]) for r in recs]
    if path == "pipelined":
        fs, rt = _fabric(pkg, root, n_threads=2, obs=obs, depth=2)
        for t, tok, keys, ops, params in sched:
            rt.announce(t, keys, ops, params, token=tok)
            rt.combine_phase()
        rt.flush()
        return fs, rt, [rt.shard_contents(s) for s in range(4)]
    fs, rt = _fabric(pkg, root, n_threads=2, obs=obs, depth=3, chain=2)
    drv = PKGS[pkg][3].MultiThreadDriver(rt, seed=7)
    for t, _, keys, ops, params in sched:
        drv.submit(t, keys, ops, params)
    drv.run()
    return fs, rt, [drv.dispatch_order] + [rt.shard_contents(s) for s in range(4)]


def _traced(pkg, root):
    return PKGS[pkg][0].FabricObserver(root=root)


# ------------------------------------------------------------- purity gates
@pytest.mark.parametrize("path", ["fused", "pipelined", "multithread"])
def test_traced_run_is_pure_and_matches_jax(path, tmp_path):
    """Traced and untraced runs of the port leave the same durable root,
    per-tag counts and results; the traced run's root, counts and event
    sequence equal the reference's on the same schedule."""
    runs = {}
    for pkg in PKGS:
        plain = _drive(pkg, path, tmp_path / f"{pkg}_plain")
        obs = _traced(pkg, tmp_path / f"{pkg}_traced")
        traced = _drive(pkg, path, tmp_path / f"{pkg}_traced", obs=obs)
        obs.flush()
        assert dict(plain[0].stats) == dict(traced[0].stats), pkg
        assert plain[0].pstats.as_dict() == traced[0].pstats.as_dict(), pkg
        assert plain[2] == traced[2], pkg
        digest = JO.durable_digest(tmp_path / f"{pkg}_plain")
        assert digest == TO.durable_digest(tmp_path / f"{pkg}_traced"), pkg
        events = TO.read_trace(obs.trace_path)
        seqs = [e["seq"] for e in events]
        assert seqs == list(range(len(events)))
        assert sum(e["ev"] == TO.EV_PWB for e in events) == traced[0].stats["pwb"]
        assert sum(e["ev"] == TO.EV_PFENCE for e in events) == traced[0].stats["pfence"]
        runs[pkg] = (digest, traced[0].pstats.as_dict(), _untimed(events), traced[2])
    assert runs["torch"][:2] == runs["jax"][:2]
    got, want = runs["torch"][2], runs["jax"][2]
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    assert got == want
    names = {e["ev"] for e in got}
    expect = {"pwb", "pfence", "epoch_commit", "announce", "dispatch", "topology", "fabric"}
    expect |= {"drain"} if path == "fused" else {"retire"}
    expect |= {"sched"} if path == "multithread" else set()
    assert expect <= names, names


def test_read_responses_and_stale_token_unchanged_by_tracing(tmp_path):
    """``read_responses`` values and ``StaleTokenError`` are the same with
    the observer attached."""
    vals = {}
    for name, obs in (("plain", None), ("traced", _traced("torch", tmp_path / "traced"))):
        _, rt, _ = _drive("torch", "fused", tmp_path / name, obs=obs)
        for t in (0, 1):
            for tok in (2, 3):  # the two retained slots
                vals[(name, t, tok)] = rt.read_responses(t, token=tok)
            with pytest.raises(TS.StaleTokenError):
                rt.read_responses(t, token=1)
    for t in (0, 1):
        for tok in (2, 3):
            a, b = vals[("plain", t, tok)], vals[("traced", t, tok)]
            assert a["resp"] == b["resp"] and a["kinds"] == b["kinds"]


# --------------------------------------------------------- crash + recovery
def _report_shape(report):
    return {
        t: {"token": r["token"], "applied": [bool(v.applied) for v in r["ops"]],
            "prev": None if not r.get("prev") else {
                "token": r["prev"]["token"],
                "applied": [bool(v.applied) for v in r["prev"]["ops"]]}}
        for t, r in report.items()
    }


def _crash_and_recover(pkg, root, k, traced):
    o, ck, rt_mod, *_ = PKGS[pkg]
    sched = _schedule(2, 2, 3, seed=42)
    obs = o.FabricObserver(root=root) if traced else None
    fs, rt = _fabric(pkg, root, n_threads=2, obs=obs, crash_at=k)
    try:
        rt.phase_loop(sched)
    except ck.CrashNow:
        pass
    pre = o.read_trace(obs.trace_path) if traced else None
    obs2 = o.FabricObserver(root=root) if traced else None
    _, report = rt_mod.ShardedDFCRuntime.recover(
        ck.SimFS(root), kind=KINDS, n_shards=4, capacity=CAP, lanes=LANES, n_threads=2,
        obs=obs2, **PKGS[pkg][5])
    post = o.read_trace(obs2.trace_path) if traced else None
    return _report_shape(report), pre, post


def test_crash_sweep_traced_matches_untraced_and_jax(tmp_path):
    """Crash at every third persistence op of the fused drain with tracing
    on: the port's recovery report equals the untraced crash's at the same
    op; the sidecar is a prefix with monotone ``seq`` that recovery
    extends with ``recover`` begin/end and one ``verdict`` per announced
    thread; and the whole timeline, crash and recovery, equals the
    reference's without timings."""
    fs, rt = _fabric("torch", tmp_path / "dry", n_threads=2)
    rt.phase_loop(_schedule(2, 2, 3, seed=42))
    total = fs.injector.count
    assert total > 60
    for k in range(1, total + 1, 3):
        plain, _, _ = _crash_and_recover("torch", tmp_path / f"p{k}", k, traced=False)
        got, pre, post = _crash_and_recover("torch", tmp_path / f"t{k}", k, traced=True)
        assert got == plain, k
        seqs = [e["seq"] for e in post]
        assert seqs == list(range(len(post))) and post[: len(pre)] == pre, k
        assert [e["stage"] for e in post if e["ev"] == TO.EV_RECOVER][-2:] == ["begin", "end"]
        surfaced = sum(1 for r in got.values() if r["token"] is not None)
        assert sum(e["ev"] == TO.EV_VERDICT for e in post) == surfaced, k
        want, _, jpost = _crash_and_recover("jax", tmp_path / f"j{k}", k, traced=True)
        assert got == want, k
        assert _untimed(post) == _untimed(jpost), k


def test_recovery_trace_continues_seq_numbering(tmp_path):
    """A fresh observer on an existing sidecar continues the ``seq``
    timeline: recovery's events read as one ordered log with the run's."""
    obs = _traced("torch", tmp_path)
    _, _, _ = _drive("torch", "fused", tmp_path, obs=obs)
    obs.flush()
    first = TO.read_trace(obs.trace_path)
    obs2 = _traced("torch", tmp_path)
    TS.ShardedDFCRuntime.recover(TC.SimFS(tmp_path), kind=KINDS, n_shards=4, capacity=CAP,
                                 lanes=LANES, n_threads=2, obs=obs2, device="cpu")
    combined = TO.read_trace(obs.trace_path)
    assert combined[: len(first)] == first
    assert combined[len(first)]["seq"] == first[-1]["seq"] + 1
    assert combined[len(first)]["ev"] == TO.EV_RECOVER


def test_epoch_events_match_committed_epochs(tmp_path):
    """Each two-increment commit records one ``epoch_commit`` event whose
    last value per shard is the fabric's committed epoch; the last
    ``fabric`` sample holds the committed sizes and epochs."""
    obs = _traced("torch", tmp_path)
    _, rt, _ = _drive("torch", "pipelined", tmp_path, obs=obs)
    last = {}
    for e in obs.trace.events():
        if e["ev"] == TO.EV_EPOCH:
            last[e["shard"]] = e["epoch"]
    for s, epoch in enumerate(rt.shard_epochs()):
        assert last.get(s, 0) == int(epoch)
    sample = [e for e in obs.trace.events() if e["ev"] == TO.EV_FABRIC][-1]
    assert sample["backlog"] == [int(x) for x in rt.shard_sizes()]
    assert sample["epochs"] == [int(x) for x in rt.shard_epochs()]
    gauges = obs.metrics.snapshot()["gauges"]
    assert gauges["shard_backlog{kind=queue,shard=0}"] == int(rt.shard_sizes()[0])
    json.dumps(obs.metrics.snapshot())  # every recorded value is a plain number


# ------------------------------------------------------- metrics + exporters
@pytest.mark.parametrize("values", [
    list(range(1, 1001)),
    [0.0, 0.0, 3.5, 0.0],
    [7.25],
    list(np.random.default_rng(0).lognormal(2.0, 1.5, 500)),
    [],
], ids=["linear", "zeros", "one", "lognormal", "empty"])
def test_histogram_matches_jax(values):
    """The same samples give the reference's summary, bucket for bucket."""
    hs = {}
    for pkg in PKGS:
        h = PKGS[pkg][0].Histogram()
        for v in values:
            h.record(v)
        hs[pkg] = h
    assert hs["torch"].buckets == hs["jax"].buckets
    assert hs["torch"].summary() == hs["jax"].summary()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert hs["torch"].percentile(q) == hs["jax"].percentile(q)
    if values == list(range(1, 1001)):
        s = hs["torch"].summary()
        assert 400 <= s["p50"] <= 600 and 900 <= s["p99"] <= 1000


def test_registry_and_exporters_match_jax(tmp_path):
    """Counters, gauges, histograms, ``to_jsonl``, ``to_chrome_trace`` and
    ``bridge_persist_stats`` write the reference's bytes."""
    events = [
        {"seq": 0, "ts_us": 100, "ev": "announce", "thread": 1, "dur_us": 40},
        {"seq": 1, "ts_us": 200, "ev": "epoch_commit", "shard": 0},
        {"seq": 2, "ts_us": 250.5, "ev": "request", "stage": "admit", "pairs": [[1, 2]]},
    ]
    out = {}
    for pkg in PKGS:
        o, ck = PKGS[pkg][0], PKGS[pkg][1]
        reg = o.MetricsRegistry()
        reg.counter("hits", shard=0)
        reg.counter("hits", 2, shard=0)
        reg.counter_set("abs", 9, tag="x")
        reg.gauge("backlog", 7, shard=1, kind="queue")
        for v in (4.0, 0.0, 12.5):
            reg.observe("lat_ms", v)
        fs = ck.SimFS(tmp_path / f"fs_{pkg}")
        fs.write("a", b"x", tag="announce")
        fs.fsync(["a"], tag="announce")
        fs.write("b", b"y")
        o.bridge_persist_stats(reg, fs.pstats)
        n_m = reg.to_jsonl(tmp_path / f"{pkg}.jsonl")
        n_e = o.to_chrome_trace(events, tmp_path / f"{pkg}.json")
        out[pkg] = (reg.snapshot(), n_m, n_e, (tmp_path / f"{pkg}.jsonl").read_text(),
                    (tmp_path / f"{pkg}.json").read_text())
        null = o.NullMetrics()
        null.counter("x")
        null.observe("y", 1.0)
        assert null.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert out["torch"] == out["jax"]
    doc = json.loads(out["torch"][4])
    assert doc[0]["ph"] == "X" and doc[0]["ts"] == 60 and doc[1]["ph"] == "i"
    assert out["torch"][0]["counters"]["persist_pwb_total"] == 2


def test_null_observer_is_inert(tmp_path):
    """The default observer records nothing, and ``SimFS`` runs its hooks
    after the counters and the durable work."""
    assert not TO.NULL_OBS.enabled and TO.NULL_OBS.trace.events() == []
    with TO.NULL_OBS.span("x"):
        pass
    seen = []

    class Spy(TO.NullObserver):
        def on_pwb(self, rel, tag):
            seen.append(("pwb", rel, fs.stats["pwb"], rel in fs.pending))

        def on_pfence(self, rels, tag):
            seen.append(("pfence", tuple(rels), fs.stats["pfence"], (tmp_path / "a").exists()))

    fs = TC.SimFS(tmp_path)
    fs.obs = Spy()
    fs.write("a", b"x", tag="t")
    fs.fsync(["a"], tag="t")
    assert seen == [("pwb", "a", 1, True), ("pfence", ("a",), 1, True)]


# ------------------------------------------------------------- serving tier
def test_tier_latency_stats():
    """An observed tier reports admission, service and end-to-end latency
    (count, p50 <= p99); an unobserved one reports None."""
    obs = TO.FabricObserver()
    tier = TV.RequestQueueTier(n_queues=2, slots=4, capacity=512, lanes=16, durable=True,
                               obs=obs, device="cpu")
    tier.submit([1, 2, 3, 4])
    admitted = tier.admit(4)
    assert len(admitted) == 4
    for sid, _ in admitted:
        tier.mark_served(sid)
    stats = tier.latency_stats()
    assert sorted(stats) == ["admission_ms", "e2e_ms", "service_ms"]
    for s in stats.values():
        assert s["count"] == 4 and 0 <= s["p50"] <= s["p99"]
    plain = TV.RequestQueueTier(n_queues=2, slots=4, capacity=512, lanes=16, durable=True,
                                device="cpu")
    assert plain.latency_stats() is None
    plain.mark_served(1)  # a no-op for the observer, not a crash


@pytest.mark.parametrize("durable", [False, True], ids=["volatile", "durable"])
def test_tier_traced_is_pure_and_matches_jax(durable, tmp_path):
    """The serving tier with and without the observer: the same rejections,
    counts and durable root; the traced tier's events (request lifecycle
    included) equal the reference's without timings."""
    waves = [([1, 2, 3], [], None, [0, 1, 2]), ([4, 5], [], None, [1, 1])]
    runs = {}
    for pkg in PKGS:
        o, ck, _, _, v, dev = PKGS[pkg]
        for name in ("plain", "traced"):
            obs = o.FabricObserver(root=tmp_path / f"{pkg}_{name}") if name == "traced" else None
            fs = ck.SimFS(tmp_path / f"{pkg}_{name}") if durable else None
            tier = v.RequestQueueTier(slots=2, capacity=512, lanes=16, durable=durable, fs=fs,
                                      obs=obs, k_classes=3, **dev)
            rej = tier.submit_waves(waves)
            rej.append(tier.submit([6, 7], classes=[2, 0]))
            admitted = tier.admit(2)
            tier.record_progress({sid: 3 for sid, _ in admitted})
            for sid, _ in admitted:
                tier.mark_served(sid)
            tier.submit([], release_slots=[slot for _, slot in admitted])
            rec = (rej, admitted, tier.session_states(), tier.admit_log)
            if durable:
                rec += (dict(fs.stats), fs.pstats.as_dict(),
                        o.durable_digest(tmp_path / f"{pkg}_{name}"))
            runs[(pkg, name)] = rec
            if obs is not None:
                obs.flush()
                runs[(pkg, "events")] = _untimed(obs.trace.events())
                runs[(pkg, "lat")] = {k: s["count"] for k, s in tier.latency_stats().items()}
    assert runs[("torch", "plain")] == runs[("torch", "traced")] == runs[("jax", "traced")]
    assert runs[("torch", "lat")] == runs[("jax", "lat")] == {
        "admission_ms": 2, "e2e_ms": 2, "service_ms": 2}
    got, want = runs[("torch", "events")], runs[("jax", "events")]
    stages = [e["stage"] for e in got if e["ev"] == "request"]
    assert {"arrive", "admit", "served"} <= set(stages)
    assert got == want


# --------------------------------------------------------------- fabric_top
def test_fabric_top_renders_port_trace(tmp_path):
    """The reference's operator tool reads the port's sidecar: a per-shard
    table whose pwb counts match the trace's."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import fabric_top
    finally:
        sys.path.remove(str(REPO / "tools"))
    obs = _traced("torch", tmp_path)
    _drive("torch", "pipelined", tmp_path, obs=obs)
    obs.flush()
    events = TO.read_trace(obs.trace_path)
    table = fabric_top.render(events)
    assert "shard" in table and "queue" in table and "map" in table
    assert "pwb" in table and "announce" in table
    agg = fabric_top.aggregate(events)
    assert sum(agg["pwb"].values()) == sum(e["ev"] == TO.EV_PWB for e in events)
    assert set(agg["commits"]) <= set(range(4)) and agg["commits"]


def test_tier_split_lanes_and_reshard_trace_matches_jax(tmp_path):
    """A traced durable tier with per-side lanes and an autosplit: the same
    events as the reference's without timings (lane ``epoch_commit`` events
    carry ``lanes`` and ``mode``, the split a ``reshard`` event, the
    topology ``split_lanes``), a root equal to the untraced run's, and
    ``tools/fabric_top.py``'s lane panel the same for both traces."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import fabric_top
    finally:
        sys.path.remove(str(REPO / "tools"))
    runs = {}
    for pkg in PKGS:
        o, ck, _, _, v, dev = PKGS[pkg]
        for name in ("plain", "traced"):
            root = tmp_path / f"{pkg}_{name}"
            obs = o.FabricObserver(root=root) if name == "traced" else None
            tier = v.RequestQueueTier(n_queues=2, slots=2, capacity=512, lanes=16,
                                      durable=True, fs=ck.SimFS(root), obs=obs,
                                      priority=True, split_lanes=True, reshard_backlog=3,
                                      **dev)
            tier.submit([1, 2, 3, 4, 5, 6], priorities=[0, 1, 0, 0, 1, 0])
            admitted = tier.admit(2)
            for sid, _ in admitted:
                tier.mark_served(sid)
            tier.submit([7], release_slots=[slot for _, slot in admitted])
            runs[(pkg, name)] = (admitted, tier.stats, tier.rt.lane_stats(),
                                 tier.rt.fs.pstats.as_dict(), o.durable_digest(root))
            if obs is not None:
                obs.flush()
                events = o.read_trace(obs.trace_path)
                runs[(pkg, "events")] = _untimed(events)
                runs[(pkg, "top")] = fabric_top.render(events)
    assert runs[("torch", "plain")] == runs[("torch", "traced")] == runs[("jax", "traced")]
    got = runs[("torch", "events")]
    assert got == runs[("jax", "events")]
    lane_commits = [e for e in got if e["ev"] == TO.EV_EPOCH and "lanes" in e]
    assert lane_commits and {e["mode"] for e in lane_commits} <= {"head", "tail", "handoff"}
    assert all(e["epoch"] == sum(e["lanes"]) for e in lane_commits)
    splits = runs[("torch", "traced")][1]["splits"]
    assert splits >= 1
    assert [e["op"] for e in got if e["ev"] == TO.EV_RESHARD] == ["split"] * splits
    assert next(e for e in got if e["ev"] == TO.EV_TOPOLOGY)["split_lanes"] is True
    assert runs[("torch", "top")] == runs[("jax", "top")]
    assert "eH/eT" in runs[("torch", "top")]
