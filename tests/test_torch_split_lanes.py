"""Per-side lanes in the port against the JAX package, on the CPU.

A split (``split_lanes=True``) queue or deque shard commits its head side and
its tail side through their own lane records and epochs, and both at once
(the handoff) when a phase mixes the sides or drains the shard.  The device
steps (``dfc_lane_combine_step``, ``dfc_handoff_combine_step``) must equal
the JAX steps bit for bit; the durable layer must write the same bytes: at
every crash point of a two-lane schedule (tail-only, head-only, mixed
handoff and drained-upgrade phases) the port's root, per-tag counts, lane
pairs, verdicts and replay equal the reference's, and each package recovers
the other's root.
"""

import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.core import jax_dfc as J  # noqa: E402
from repro.kernels.dfc_reduce import ops as JO  # noqa: E402
from repro.launch import serve as JV  # noqa: E402
from repro.obs.trace import durable_digest  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.kernels.dfc_reduce import ops as TO  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CAP, LANES = 128, 16
JAXPKG = types.SimpleNamespace(name="jax", fs=JC.SimFS, inj=JC.FaultInjector,
                               crash=JC.CrashNow, rt=JS.ShardedDFCRuntime,
                               kw={"backend": "ref"})
TORCHPKG = types.SimpleNamespace(name="torch", fs=TC.SimFS, inj=TC.FaultInjector,
                                 crash=TC.CrashNow, rt=TS.ShardedDFCRuntime,
                                 kw={"device": "cpu"})
PKGS = (JAXPKG, TORCHPKG)


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def assert_fabric_same(jrt, trt):
    assert jrt.kinds == trt.kinds and sorted(jrt.groups) == sorted(trt.groups)
    for k in jrt.groups:
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jrt.groups[k]),
                                       T.state_to_numpy(trt.groups[k]))):
            assert_same(np.asarray(a), b, f"{k} leaf {i}")
    for col in ("phases", "ops_combined", "kind"):
        assert_same(np.asarray(jrt.meta[col]), trt.meta[col].numpy(), col)
    assert jrt.lane_stats() == trt.lane_stats()


# ------------------------------------------------------------ device steps
def _states(kind, rng):
    """The same preloaded 3-shard state in both packages."""
    pre = np.tile([T.OP_ENQ if kind == "queue" else T.OP_PUSHR], (3, 8)).astype(np.int32)
    prep = (rng.random((3, 8)) * 100).round(2).astype(np.float32)
    js = jax.tree_util.tree_map(lambda x: jnp.stack([x] * 3), J.STRUCTS[kind].init(CAP))
    js = JO.dfc_handoff_combine_step(js, jnp.asarray(pre), jnp.asarray(prep), kind=kind,
                                     backend="jnp")[0]
    ts = T.state_from_numpy(kind, [np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
                            device="cpu")
    return js, ts


def _same_step(j, t):
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(j[0]),
                                   T.state_to_numpy(t[0]))):
        assert_same(np.asarray(a), b, f"leaf {i}")
    assert_same(np.asarray(j[1]), t[1].numpy(), "resp")
    assert_same(np.asarray(j[2]), t[2].numpy(), "kinds")


@pytest.mark.parametrize("kind", ["queue", "deque"])
def test_lane_and_handoff_steps_match_jax(kind):
    """Each lane's masked step and the handoff step, the port's kernel and
    torch backends against the reference's jnp steps, bit for bit; ops of
    the other lane answer R_NONE."""
    rng = np.random.default_rng(17)
    js, ts = _states(kind, rng)
    ops = rng.integers(0, T.STRUCTS[kind].n_opcodes, (3, 12)).astype(np.int32)
    params = (rng.random((3, 12)) * 100).round(2).astype(np.float32)
    jops, jpar = jnp.asarray(ops), jnp.asarray(params)
    tops, tpar = torch.from_numpy(ops), torch.from_numpy(params)
    for backend in ("kernel", "torch"):
        for lane in (T.LANE_HEAD, T.LANE_TAIL):
            j = JO.dfc_lane_combine_step(js, jops, jpar, kind=kind, lane=lane, backend="jnp")
            t = TO.dfc_lane_combine_step(ts, tops, tpar, kind=kind, lane=lane,
                                         backend=backend)
            _same_step(j, t)
            other = (T.lane_of_ops_host(kind, ops) != lane) & (ops != T.OP_NONE)
            assert (t[2].numpy()[other] == T.R_NONE).all()
        _same_step(JO.dfc_handoff_combine_step(js, jops, jpar, kind=kind, backend="jnp"),
                   TO.dfc_handoff_combine_step(ts, tops, tpar, kind=kind, backend=backend))


def test_queue_head_lane_leaves_values_untouched():
    """A head-only queue phase moves only the head counter: values and the
    tail counter stay, which is why the head lane persists no values."""
    state = T.init_sharded("queue", 1, CAP, device="cpu")
    state = TO.dfc_handoff_combine_step(
        state, torch.full((1, 6), T.OP_ENQ, dtype=torch.int32),
        torch.tensor([[1.0, 2, 3, 4, 5, 6]]), kind="queue")[0]
    new, resp, _ = TO.dfc_lane_combine_step(
        state, torch.tensor([[T.OP_DEQ, T.OP_DEQ, T.OP_NONE]], dtype=torch.int32),
        torch.zeros((1, 3)), kind="queue", lane=T.LANE_HEAD)
    assert torch.equal(new.values, state.values)
    a, b = (int(new.epoch[0]) // 2) % 2, (int(state.epoch[0]) // 2) % 2
    assert int(new.ends[0, a, 1]) == int(state.ends[0, b, 1])
    assert int(new.ends[0, a, 0]) == int(state.ends[0, b, 0]) + 2
    assert resp[0, :2].tolist() == [1.0, 2.0]


def test_ring_lane_column_filters_drains():
    """The announcement ring stages a lane per op; a lane drain masks the
    other lane's ops to OP_NONE and keeps positions, as the reference's."""
    ring = T.init_announce_ring(8, device="cpu")
    keys = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    ops = torch.tensor([1, 2, 1, 2, 0, 1], dtype=torch.int32)
    params = torch.arange(6, dtype=torch.float32)
    lanes = torch.tensor([1, 0, 1, 0, -1, -1], dtype=torch.int32)
    jring = J.ring_announce(J.init_announce_ring(8), jnp.asarray(keys.numpy()),
                            jnp.asarray(ops.numpy()), jnp.asarray(params.numpy()),
                            jnp.asarray(lanes.numpy()))
    ring = T.ring_announce(ring, keys, ops, params, lanes)
    for lane in (None, T.LANE_HEAD, T.LANE_TAIL):
        for a, b in zip(J.ring_drain(jring, 2, 4, lane=lane), T.ring_drain(ring, 2, 4, lane=lane)):
            assert_same(np.asarray(a), b.numpy())
    jph = J.ring_drain_phases(jring, 0, 2, 3, lane=T.LANE_TAIL)
    for a, b in zip(jph, T.ring_drain_phases(ring, 0, 2, 3, lane=T.LANE_TAIL)):
        assert_same(np.asarray(a), b.numpy())
    ring2 = T.ring_announce_phases(T.init_announce_ring(8, device="cpu"),
                                   keys.reshape(2, 3), ops.reshape(2, 3),
                                   params.reshape(2, 3), lanes.reshape(2, 3))
    assert torch.equal(ring2.lanes[:6], lanes)


# -------------------------------------------------------- two-lane sweeps
def _lane_schedule(kind):
    """Single-thread, single-shard phases through every lane mode (after
    the reference's split-combiner suite): tail-only, head-only, a head
    phase that drains the shard (handoff), a mixed phase (handoff)."""
    if kind == "queue":
        E, D = T.OP_ENQ, T.OP_DEQ
        rows = [([E] * 4, [1.0, 2.0, 3.0, 4.0]), ([E] * 3, [5.0, 6.0, 7.0]),
                ([D] * 3, [0.0] * 3), ([D] * 4, [0.0] * 4), ([E] * 2, [8.0, 9.0]),
                ([E, D], [10.0, 0.0]), ([D] * 2, [0.0] * 2)]
    else:
        rows = [([T.OP_PUSHR] * 4, [1.0, 2.0, 3.0, 4.0]), ([T.OP_PUSHL] * 3, [5.0, 6.0, 7.0]),
                ([T.OP_POPL] * 2, [0.0] * 2), ([T.OP_POPR] * 2, [0.0] * 2),
                ([T.OP_POPL, T.OP_POPR, T.OP_POPL], [0.0] * 3),
                ([T.OP_PUSHR, T.OP_PUSHL], [8.0, 9.0])]
    return [(i + 1, [7] * len(o), o, p) for i, (o, p) in enumerate(rows)]


def _run(pkg, root, kind, crash_at=None, phases=None):
    inj = pkg.inj(crash_at=crash_at)
    fs = pkg.fs(root, inj)
    rt = pkg.rt([kind], 1, CAP, LANES, fs=fs, n_threads=1, split_lanes=True, **pkg.kw)
    try:
        for token, keys, ops, params in phases or _lane_schedule(kind):
            rt.announce(0, keys, ops, params, token=token)
            rt.combine_phase()
        rt.flush()
    except pkg.crash:
        return rt, fs, True, inj.count
    return rt, fs, False, inj.count


def _recover(pkg, root, kind):
    return pkg.rt.recover(pkg.fs(root), kind=[kind], n_shards=1, capacity=CAP, lanes=LANES,
                          n_threads=1, split_lanes=True, **pkg.kw)


def _verdicts(report):
    def ops(r):
        return [(v.applied, v.kind, v.resp, v.shard) for v in r["ops"]]
    return {t: (r["token"], ops(r), r["prev"] and (r["prev"]["token"], ops(r["prev"])))
            for t, r in report.items()}


def _finish(rt, report, kind):
    """Replay the not-applied ops, re-drive the phases never surfaced."""
    rt.replay_pending(report)
    surfaced = report[0]["token"] or 0
    for token, keys, ops, params in _lane_schedule(kind):
        if token > surfaced:
            rt.announce(0, keys, ops, params, token=token)
            rt.combine_phase()
    rt.flush()


def _oracle(kind):
    lists = [[]]
    for _, keys, ops, params in _lane_schedule(kind):
        TS.sequential_hetero_reference([kind], lists, keys, ops, params, LANES)
    return sorted(lists[0])


def _crash_point(tmp_path, kind, k):
    """Both packages crash at op ``k``; each recovers both roots; the
    recovered fabrics, verdicts, lane pairs and replays agree; the replay
    lands on the oracle."""
    runs = {pkg.name: _run(pkg, tmp_path / f"{pkg.name}{k}", kind, crash_at=k) for pkg in PKGS}
    assert runs["jax"][2] and runs["torch"][2]
    assert durable_digest(tmp_path / f"jax{k}") == durable_digest(tmp_path / f"torch{k}")
    assert runs["jax"][1].pstats.as_dict() == runs["torch"][1].pstats.as_dict()
    for src in ("jax", "torch"):
        for by in PKGS:
            shutil.copytree(tmp_path / f"{src}{k}", tmp_path / f"{src}{k}_by{by.name}")
    got = {}
    for src in ("jax", "torch"):
        jrt, jrep = _recover(JAXPKG, tmp_path / f"{src}{k}_byjax", kind)
        trt, trep = _recover(TORCHPKG, tmp_path / f"{src}{k}_bytorch", kind)
        assert _verdicts(jrep) == _verdicts(trep), (k, src)
        assert_fabric_same(jrt, trt)
        assert all(e % 2 == 0 for pair in trt.lane_stats()["epochs"].values() for e in pair)
        got[src] = (jrt, jrep, trt, trep)
    jrt, jrep, trt, trep = got["torch"]
    _finish(jrt, jrep, kind)
    _finish(trt, trep, kind)
    assert_fabric_same(jrt, trt)
    assert durable_digest(tmp_path / f"torch{k}_byjax") == durable_digest(
        tmp_path / f"torch{k}_bytorch")
    assert sorted(trt.shard_contents(0)) == _oracle(kind), k
    return trt


@pytest.mark.parametrize("kind,stride", [("queue", 1), ("deque", 2)])
def test_two_lane_crash_sweep_matches_jax(tmp_path, kind, stride):
    """A crash at every ``stride``-th persistence op of the two-lane
    schedule (lane records, values, responses and both sides of every lane
    commit): the same root, counts, verdicts, lane pairs and replay in both
    packages, each recovering the other's root, exactly once."""
    jrt, jfs, _, total = _run(JAXPKG, tmp_path / "jdry", kind)
    trt, tfs, crashed, total_t = _run(TORCHPKG, tmp_path / "tdry", kind)
    assert not crashed and total == total_t > 30
    assert durable_digest(tmp_path / "jdry") == durable_digest(tmp_path / "tdry")
    assert jfs.pstats.as_dict() == tfs.pstats.as_dict()
    assert_fabric_same(jrt, trt)
    for token, *_ in _lane_schedule(kind):
        if token >= len(_lane_schedule(kind)) - 1:
            assert jrt.read_responses(0, token=token) == trt.read_responses(0, token=token)
    for k in range(1, total + 1, stride):
        _crash_point(tmp_path, kind, k)


def test_handoff_crash_both_sides(tmp_path):
    """Crash at the handoff commit of the drained phase (token 4): before
    its fsync both lanes roll back together, after it both round up."""
    trt, _, _, _ = _run(TORCHPKG, tmp_path / "dry", "queue")
    assert trt.lane_stats()["epochs"][0] == [4 * 2, 6 * 2]
    phases = _lane_schedule("queue")
    *_, c3 = _run(TORCHPKG, tmp_path / "c3", "queue", phases=phases[:3])
    *_, c4 = _run(TORCHPKG, tmp_path / "c4", "queue", phases=phases[:4])
    pre = _recover(TORCHPKG, tmp_path / "c3", "queue")[0].lane_stats()["epochs"][0]
    post = _recover(TORCHPKG, tmp_path / "c4", "queue")[0].lane_stats()["epochs"][0]
    assert post == [pre[0] + 2, pre[1] + 2]  # the drained phase is a handoff
    # the phase's last three ops: odd pair, its fsync, even pair
    for k, want in ((c4 - 2, pre), (c4 - 1, pre), (c4, post)):
        trt = _crash_point(tmp_path, "queue", k)
        rt, _ = _recover(TORCHPKG, tmp_path / f"torch{k}", "queue")
        assert rt.lane_stats()["epochs"][0] == want, (k, want)
    assert c3 < c4 - 2


def test_tier_lane_pairs_across_recovery(tmp_path):
    """The serving tier with per-side lanes: arrivals on the tail lanes,
    admissions on the head lanes; both packages hold the same pairs, write
    the same root, and recover the pairs after a crash."""
    pkgs = {"jax": (JV, JC, {}), "torch": (TV, TC, {"device": "cpu"})}
    out = {}
    for name, (V, C, kw) in pkgs.items():
        fs = C.SimFS(tmp_path / name)
        tier = V.RequestQueueTier(n_queues=2, slots=2, capacity=256, lanes=16, durable=True,
                                  split_lanes=True, fs=fs, priority=True, **kw)
        tier.submit([1, 2, 3, 4], priorities=[0, 0, 1, 0])
        admitted = tier.admit(2)
        tier.submit([5, 6], release_slots=[slot for _, slot in admitted])
        tier.admit(1)
        out[name] = (tier.rt.lane_stats(), admitted, fs.pstats.as_dict())
    assert out["jax"] == out["torch"]
    assert any(p != [0, 0] for p in out["torch"][0]["epochs"].values())
    assert durable_digest(tmp_path / "jax") == durable_digest(tmp_path / "torch")
    for name, (V, C, kw) in pkgs.items():
        tier, info = V.RequestQueueTier.recover(C.SimFS(tmp_path / "torch"), n_queues=2,
                                                capacity=256, lanes=16, split_lanes=True,
                                                priority=True, **kw)
        assert tier.rt.lane_stats()["epochs"] == out["torch"][0]["epochs"], name
        assert tier.split_lanes


# -------------------------------------------------------------- jitter
def _queue_lane_cost(pkg, root, split, skewed):
    """Steady-state pwb/op and pfence/op of a one-shard queue, one lane or
    two, under arrival skew (tail-only and head-only bursts over a standing
    backlog) or drained (balanced phases that fully eliminate); after the
    reference's elimination-jitter suite."""
    m, n_phases = 8, 6
    fs = pkg.fs(root)
    rt = pkg.rt("queue", 1, 256, 32, fs=fs, n_threads=1, split_lanes=split, **pkg.kw)
    key = rt.key_for_shard(0)
    token = [0]

    def phase(ops, params):
        token[0] += 1
        rt.announce(0, [key] * len(ops), ops, params, token=token[0])
        rt.combine_phase()

    if skewed:
        phase([T.OP_PUSH] * (3 * m), [float(i) for i in range(3 * m)])
        for p in (1, 2):
            phase([T.OP_PUSH] * m, [100.0 * p + i for i in range(m)])
            phase([T.OP_POP] * m, [0.0] * m)
        base = dict(fs.stats)
        for p in range(n_phases):
            phase([T.OP_PUSH] * m, [100.0 * (10 + p) + i for i in range(m)])
            phase([T.OP_POP] * m, [0.0] * m)
    else:
        for _ in (1, 2):
            phase([T.OP_PUSH] * m + [T.OP_POP] * m, [float(i) for i in range(2 * m)])
        base = dict(fs.stats)
        for p in range(n_phases):
            phase([T.OP_PUSH] * m + [T.OP_POP] * m, [10.0 * p + i for i in range(2 * m)])
    n = n_phases * 2 * m
    return ((fs.stats["pwb"] - base["pwb"]) / n, (fs.stats["pfence"] - base["pfence"]) / n)


def test_split_lanes_beat_one_lane_under_skew(tmp_path):
    """Under skew two lanes pay fewer pwb/op than one; drained they tie,
    down to pfence/op; and both packages measure the same numbers."""
    costs = {(pkg.name, split, skewed): _queue_lane_cost(
        pkg, tmp_path / f"{pkg.name}{int(split)}{int(skewed)}", split, skewed)
        for pkg in PKGS for split in (False, True) for skewed in (False, True)}
    for split in (False, True):
        for skewed in (False, True):
            assert costs[("jax", split, skewed)] == costs[("torch", split, skewed)]
    c = {k[1:]: v for k, v in costs.items() if k[0] == "torch"}
    assert c[(True, True)][0] < c[(False, True)][0]
    assert c[(True, False)] == c[(False, False)]
    assert c[(False, True)][0] > c[(False, False)][0]
    assert c[(True, True)][0] > c[(True, False)][0]


# ------------------------------------------------------ responses by lane
def test_read_responses_by_lane_interleaved(tmp_path):
    """Head and tail batches with interleaved tokens on one thread: the
    lane view and the staleness rule (judged across both lanes) agree with
    the reference's."""
    rts = {}
    for pkg in PKGS:
        fs = pkg.fs(tmp_path / pkg.name)
        rts[pkg.name] = rt = pkg.rt(["queue", "deque"], 2, CAP, LANES, fs=fs, n_threads=1,
                                    split_lanes=True, **pkg.kw)
        kq, kd = rt.key_for_shard(0), rt.key_for_shard(1)
        batches = [([kq, kq, kd], [T.OP_ENQ, T.OP_ENQ, T.OP_PUSHL], [1.0, 2.0, 3.0]),
                   ([kq, kd], [T.OP_DEQ, T.OP_PUSHR], [0.0, 4.0]),
                   ([kd, kq, kd], [T.OP_POPL, T.OP_ENQ, T.OP_POPR], [0.0, 5.0, 0.0]),
                   ([kq], [T.OP_DEQ], [0.0])]
        for token, b in enumerate(batches, 1):
            rt.announce(0, *b, token=token)
            rt.combine_phase()
    jrt, trt = rts["jax"], rts["torch"]
    for token in (3, 4):
        for lane in (None, T.LANE_HEAD, T.LANE_TAIL, T.LANE_NONE):
            got = trt.read_responses(0, token=token, lane=lane)
            assert got == jrt.read_responses(0, token=token, lane=lane)
            if lane is not None:
                assert set(got["lanes"]) <= {lane}
    assert trt.read_responses(0, lane=T.LANE_TAIL) == jrt.read_responses(0, lane=T.LANE_TAIL)
    for lane in (T.LANE_HEAD, T.LANE_TAIL):
        with pytest.raises(TS.StaleTokenError):
            trt.read_responses(0, token=2, lane=lane)
    assert trt.read_responses(0, token=9, lane=T.LANE_HEAD) is None


# --------------------------------------------------------- fused drain
@pytest.mark.parametrize("axis", ["grid", "scan"])
def test_phase_loop_split_lanes_matches_serial(tmp_path, axis):
    """``phase_loop`` on a split-lane mixed fabric writes the serial
    drive's root (each entry its own phase), in both packages (the
    reference's grid axis runs its Pallas kernel in interpret mode)."""
    kinds = ["deque", "map", "queue", "stack"] * 2
    rng = np.random.default_rng(23)
    nops = np.asarray([T.STRUCTS[k].n_opcodes for k in kinds])
    sched = []
    for p in range(3):
        for t in range(3):
            keys = rng.integers(0, 1000, 8)
            ops = rng.integers(1, nops[TS.shard_of_keys_host(keys, 8)])
            sched.append((t, p + 1, keys, ops, (rng.random(8) * 100).round(2).astype(np.float32)))

    def fabric(pkg, name):
        fs = pkg.fs(tmp_path / name)
        kw = dict(pkg.kw, backend="pallas") if pkg is JAXPKG and axis == "grid" else pkg.kw
        return pkg.rt(kinds, 8, CAP, LANES, fs=fs, n_threads=3, split_lanes=True, **kw), fs

    serial, sfs = fabric(TORCHPKG, "serial")
    for t, tok, keys, ops, params in sched:
        serial.announce(t, keys, ops, params, token=tok)
        serial.combine_phase()
    loops = {}
    for pkg in PKGS:
        rt, fs = fabric(pkg, f"{pkg.name}_loop")
        recs = rt.phase_loop(sched, phase_axis=axis)
        assert durable_digest(tmp_path / f"{pkg.name}_loop") == durable_digest(tmp_path / "serial")
        assert fs.pstats.as_dict() == sfs.pstats.as_dict()
        loops[pkg.name] = (rt, recs)
    assert loops["jax"][1] == loops["torch"][1]
    assert all("lanes" in r for r in loops["torch"][1])
    assert_fabric_same(loops["jax"][0], loops["torch"][0])
    assert loops["torch"][0].lane_stats() == serial.lane_stats()
