"""Resharding in the port against the JAX package, on the CPU.

``split_shard`` moves half of a hot shard's buckets to a new shard and
``merge_shards`` folds a cold shard into another of its kind; both are
crash-consistent mini-transactions (donor snapshot, intent, routing record,
the rEpoch commit).  At every crash point of a split and a merge (on
split-lane shards too) the port's recovered root, per-tag counts and
verdicts equal the reference's, each package recovers the other's root, and
the replay applies every op exactly once.  The durable tier that autosplits
serves the reference's order, and the detectable checkpoint manager writes
the reference's bytes.
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
from repro.launch import serve as JV  # noqa: E402
from repro.obs.trace import durable_digest  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CAP, LANES = 256, 16
PUSH_OF = {"stack": T.OP_PUSH, "queue": T.OP_ENQ, "deque": T.OP_PUSHR}
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
    assert jrt.kinds == trt.kinds and jrt.n_shards == trt.n_shards
    assert_same(jrt.table, trt.table, "table")
    assert jrt.r_epoch == trt.r_epoch
    for k in jrt.groups:
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jrt.groups[k]),
                                       T.state_to_numpy(trt.groups[k]))):
            assert_same(np.asarray(a), b, f"{k} leaf {i}")
    for col in ("phases", "ops_combined", "kind"):
        assert_same(np.asarray(jrt.meta[col]), trt.meta[col].numpy(), col)
    assert jrt.lane_stats() == trt.lane_stats()


# ------------------------------------------------------------ in memory
def test_split_moves_buckets_and_relieves_overflow():
    """Half of the donor's buckets move to a new empty shard; the hot batch
    that overflowed no longer does; both packages agree bit for bit."""
    rts = [JS.ShardedDFCRuntime("queue", 2, CAP, lanes=4, n_buckets=16, backend="ref"),
           TS.ShardedDFCRuntime("queue", 2, CAP, lanes=4, n_buckets=16, device="cpu")]
    keys = [rts[1].key_for_shard(0, start=i * 5000) for i in range(6)]
    outs = []
    for rt in rts:
        _, kinds = rt.step(keys, [T.OP_ENQ] * 6, [float(i) for i in range(6)])
        assert list(np.asarray(kinds)).count(TS.R_OVERFLOW) == 2
        before = rt.shard_contents(0)
        new_id = rt.split_shard(0)
        assert (rt.n_shards, rt.kinds[new_id]) == (3, "queue") and new_id == 2
        assert rt.shard_contents(0) == before and rt.shard_contents(new_id) == []
        assert (rt.table == 0).sum() == (rt.table == 2).sum() == 4
        assert set(TS.route_keys_host(np.asarray(keys), rt.n_shards, rt.table)) == {0, 2}
        resp, kinds = rt.step(keys, [T.OP_ENQ] * 6, [10.0 + i for i in range(6)])
        assert TS.R_OVERFLOW not in list(np.asarray(kinds))
        outs.append((np.asarray(resp), np.asarray(kinds)))
    assert_same(outs[0][0], outs[1][0])
    assert_same(outs[0][1], outs[1][1])
    assert_fabric_same(*rts)


def test_split_requires_spare_bucket_and_merge_same_kind():
    rt = TS.ShardedDFCRuntime(["stack", "queue"], 2, CAP, LANES, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        rt.split_shard(0)
    with pytest.raises(ValueError, match="kind mismatch"):
        rt.merge_shards(0, 1)
    with pytest.raises(ValueError, match="itself"):
        rt.merge_shards(1, 1)
    small = TS.ShardedDFCRuntime("queue", 2, 8, 4, n_buckets=4, device="cpu")  # 5 + 4 > 8
    small.step([small.key_for_shard(1)] * 3 + [small.key_for_shard(0)] * 2,
               [T.OP_ENQ] * 5, [1.0, 2.0, 3.0, 4.0, 5.0])
    with pytest.raises(ValueError, match="capacity"):
        small.merge_shards(1, 0)


@pytest.mark.parametrize("kind", ["stack", "queue", "deque", "map"])
def test_merge_appends_contents(kind):
    """``dst`` absorbs ``src``'s contents after its own, ``src`` empties,
    every bucket routes to ``dst``; both packages hold the same bytes."""
    rts = [JS.ShardedDFCRuntime(kind, 2, CAP, LANES, n_buckets=8, backend="ref"),
           TS.ShardedDFCRuntime(kind, 2, CAP, LANES, n_buckets=8, device="cpu")]
    for rt in rts:
        for s, vals in ((0, [1.0, 2.0]), (1, [3.0, 4.0])):
            keys = [rt.key_for_shard(s, start=100 * i) for i in range(2)]
            op = T.OP_MAP_INSERT if kind == "map" else PUSH_OF[kind]
            rt.step(keys, [op] * 2, vals)
        rt.merge_shards(1, 0)
        if kind != "map":
            assert rt.shard_contents(0) == [1.0, 2.0, 3.0, 4.0]
        assert rt.shard_contents(1) == [] and set(rt.table.tolist()) == {0}
    assert rts[0].shard_contents(0) == rts[1].shard_contents(0)
    assert_fabric_same(*rts)


def test_recover_topology_from_routing_record(tmp_path):
    """Recovery adopts the committed routing record (kinds, shard count,
    table, buckets) over stale bootstrap arguments, in either package and
    from either package's root."""
    for pkg in PKGS:
        fs = pkg.fs(tmp_path / pkg.name)
        rt = pkg.rt(["queue", "stack"], 2, CAP, LANES, fs=fs, n_threads=1, n_buckets=8,
                    **pkg.kw)
        rt.announce(0, [rt.key_for_shard(0)] * 2, [T.OP_ENQ] * 2, [5.0, 6.0], token=1)
        rt.combine_phase()
        rt.split_shard(0)
    assert durable_digest(tmp_path / "jax") == durable_digest(tmp_path / "torch")
    got = {}
    for src in ("jax", "torch"):
        for pkg in PKGS:
            root = tmp_path / f"{src}_by{pkg.name}"
            shutil.copytree(tmp_path / src, root)
            rt2, _ = pkg.rt.recover(pkg.fs(root), kind="deque", n_shards=1, capacity=CAP,
                                    lanes=LANES, **pkg.kw)
            assert rt2.n_shards == 3 and rt2.kinds == ["queue", "stack", "queue"]
            assert rt2.n_buckets == 8 and rt2.r_epoch == 2
            assert rt2.shard_contents(0) == [5.0, 6.0]
            got[(src, pkg.name)] = rt2
        assert_fabric_same(got[(src, "jax")], got[(src, "torch")])


# ---------------------------------------------------------- crash sweeps
def _scenario(pkg, root, crash_at, reshard, kinds, split_lanes=False):
    """Insert-only phases around a reshard, crashed at op ``crash_at``."""
    inj = pkg.inj(crash_at=crash_at)
    fs = pkg.fs(root, inj)
    rt = pkg.rt(kinds, len(kinds), CAP, LANES, fs=fs, n_threads=1, n_buckets=8,
                split_lanes=split_lanes, **pkg.kw)
    rng = np.random.default_rng(7)
    pushes = [([int(k) for k in rng.integers(0, 1000, 8)], [PUSH_OF[kinds[0]]] * 8,
               [8.0 * b + 1 + i for i in range(8)]) for b in range(2)]
    # on split lanes a head-side phase too, so the two lane epochs differ
    before = [pushes[0]] + ([([rt.key_for_shard(1)], [T.OP_DEQ], [0.0])]
                            if split_lanes else [])
    phases = [(tok, *b) for tok, b in enumerate(before + pushes[1:], 1)]
    try:
        for i, (token, keys, ops, params) in enumerate(phases):
            if i == len(before):
                reshard(rt)
            rt.announce(0, keys, ops, params, token=token)
            rt.combine_phase()
    except pkg.crash:
        pass
    return fs, inj.count, phases


def _recover(pkg, root, kinds, split_lanes=False):
    return pkg.rt.recover(pkg.fs(root), kind=kinds, n_shards=len(kinds), capacity=CAP,
                          lanes=LANES, n_threads=1, n_buckets=8, split_lanes=split_lanes,
                          **pkg.kw)


def _verdicts(report):
    return {t: (r["token"], [(v.applied, v.kind, v.resp, v.shard) for v in r["ops"]])
            for t, r in report.items()}


def _values(rt):
    return sorted(v for s in range(rt.n_shards) for v in rt.shard_contents(s))


def _finish(rt, report, phases, split_lanes):
    """Replay the not-applied ops, re-drive what never surfaced."""
    assert all(int(e) % 2 == 0 for e in rt.shard_epochs()) and rt.r_epoch % 2 == 0
    assert len(_values(rt)) == len(set(_values(rt))), "duplicated op after recovery"
    rt.replay_pending(report)
    surfaced = report[0]["token"] or 0
    for token, keys, ops, params in phases:
        if token > surfaced:
            rt.announce(0, keys, ops, params, token=token)
            rt.combine_phase()
    want = sorted(p for _, _, ops, ps in phases for o, p in zip(ops, ps)
                  if o == PUSH_OF[rt.kinds[0]])
    got = _values(rt)
    if split_lanes:  # the head-side phase dequeued the front of shard 1
        assert len(got) == len(want) - 1 and set(got) < set(want)
    else:
        assert got == want, "lost or duplicated ops across the reshard crash"


RESHARDS = {
    "split": (["queue", "queue"], False, lambda rt: rt.split_shard(
        int(np.argmax(rt.shard_sizes())))),
    "merge": (["queue", "queue"], False, lambda rt: rt.merge_shards(1, 0)),
    "merge_split_lanes": (["deque", "deque"], True, lambda rt: rt.merge_shards(1, 0)),
}


@pytest.mark.parametrize("case,stride", [("split", 1), ("merge", 1),
                                         ("merge_split_lanes", 2)])
def test_reshard_crash_sweep_matches_jax(tmp_path, case, stride):
    """A crash at every ``stride``-th persistence op around a split or a
    merge (the donor snapshot, the intent, the routing record and both
    epoch commits): the same root and per-tag counts in both packages, the
    same verdicts and fabric from either package's recovery of either root,
    and a replay that applies every op exactly once."""
    kinds, split_lanes, reshard = RESHARDS[case]
    fs, total, _ = _scenario(TORCHPKG, tmp_path / "dry", None, reshard, kinds, split_lanes)
    jfs, jtotal, _ = _scenario(JAXPKG, tmp_path / "jdry", None, reshard, kinds, split_lanes)
    assert total == jtotal > 40
    assert durable_digest(tmp_path / "dry") == durable_digest(tmp_path / "jdry")
    assert fs.pstats.as_dict() == jfs.pstats.as_dict()
    for k in range(1, total + 1, stride):
        for pkg in PKGS:
            _, _, phases = _scenario(pkg, tmp_path / f"{pkg.name}{k}", k, reshard, kinds,
                                     split_lanes)
        assert durable_digest(tmp_path / f"jax{k}") == durable_digest(tmp_path / f"torch{k}")
        recs = {}
        for src in ("jax", "torch"):
            for pkg in PKGS:
                root = tmp_path / f"{src}{k}_by{pkg.name}"
                shutil.copytree(tmp_path / f"{src}{k}", root)
                recs[(src, pkg.name)] = _recover(pkg, root, kinds, split_lanes)
            (jrt, jrep), (trt, trep) = recs[(src, "jax")], recs[(src, "torch")]
            assert _verdicts(jrep) == _verdicts(trep), (k, src)
            assert_fabric_same(jrt, trt)
        for pkg in PKGS:
            _finish(*recs[("torch", pkg.name)], phases, split_lanes)
        assert_fabric_same(recs[("torch", "jax")][0], recs[("torch", "torch")][0])
        assert (durable_digest(tmp_path / f"torch{k}_byjax")
                == durable_digest(tmp_path / f"torch{k}_bytorch")), k


def test_reshard_again_after_any_crash(tmp_path):
    """After a crash anywhere in a split (the donor snapshot's own epoch
    commit included) the recovered fabric splits again."""
    kinds, _, reshard = RESHARDS["split"]
    _, total, _ = _scenario(TORCHPKG, tmp_path / "dry", None, reshard, kinds)
    for k in range(1, total + 1, 3):
        _scenario(TORCHPKG, tmp_path / f"k{k}", k, reshard, kinds)
        rt, report = _recover(TORCHPKG, tmp_path / f"k{k}", kinds)
        rt.replay_pending(report)
        try:
            rt.split_shard(int(np.argmax(rt.shard_sizes())))
        except ValueError:
            pass  # the hot shard may be down to one bucket
        assert rt.r_epoch % 2 == 0


# ---------------------------------------------------------- serving tier
def test_durable_autosplit_tier_matches_jax(tmp_path):
    """The durable tier with ``reshard_backlog``: the same splits, the same
    served order and the same root as the reference's tier; then a crash
    mid-run recovers the split topology in both packages."""
    pkgs = {"jax": (JV, JC, {}), "torch": (TV, TC, {"device": "cpu"})}

    def drive(V, fs, kw, served):
        tier = V.RequestQueueTier(n_queues=2, slots=2, capacity=512, lanes=32, durable=True,
                                  fs=fs, reshard_backlog=3, split_lanes=True, **kw)
        sids = list(range(1, 13))
        assert tier.submit(sids) == []
        for _ in range(30):
            admitted = tier.admit(2)
            served += [sid for sid, _ in admitted]
            tier.submit([], release_slots=[slot for _, slot in admitted])
            if len(served) == len(sids):
                break
        return tier

    out = {}
    for name, (V, C, kw) in pkgs.items():
        served = []
        tier = drive(V, C.SimFS(tmp_path / name), kw, served)
        assert tier.stats["splits"] >= 1 and tier.rt.n_shards > 4
        assert sorted(served) == list(range(1, 13))
        out[name] = (served, tier.stats, tier.persistence_stats(), tier.rt.kinds,
                     tier.rt.lane_stats(), tier.rt.fs.pstats.as_dict())
    assert out["jax"] == out["torch"]
    assert durable_digest(tmp_path / "jax") == durable_digest(tmp_path / "torch")
    total = sum(out["torch"][-1]["pwb"].values()) + sum(out["torch"][-1]["pfence"].values())
    served = []
    fs = TC.SimFS(tmp_path / "crash", TC.FaultInjector(crash_at=total // 2))
    with pytest.raises(TC.CrashNow):
        drive(TV, fs, {"device": "cpu"}, served)
    for name, (V, C, kw) in pkgs.items():
        root = tmp_path / f"crash_by{name}"
        shutil.copytree(tmp_path / "crash", root)
        tier, info = V.RequestQueueTier.recover(C.SimFS(root), n_queues=2, capacity=512,
                                                lanes=32, reshard_backlog=3, **kw)
        out[name] = (tier.rt.kinds, tier.n_queues, tier.pool_shard, tier.session_shard,
                     info["queued"], info["pool"], tier.split_lanes)
    assert out["jax"] == out["torch"]
    assert out["torch"][1] > 2 and out["torch"][-1]


# ----------------------------------------------------- checkpoint manager
def _tree(rng):
    return {"w": rng.random((3, 4)).astype(np.float32),
            "b": [rng.integers(0, 9, 5).astype(np.int32), np.float32(2.5)],
            "step": np.int64(7)}


def test_checkpoint_manager_writes_the_reference_bytes(tmp_path):
    """``combine``, ``recover`` (roll forward and LOST), ``combine_structure``
    and ``load_structure``: the same bytes as the reference's manager, and
    each package loads the other's root."""
    rng = np.random.default_rng(3)
    trees = [_tree(rng) for _ in range(3)]
    jq = J.STRUCTS["queue"].init(16)
    jq = J.combine_queue(jq, jnp.asarray([1, 1, 1, 2], jnp.int32),
                         jnp.asarray([1.0, 2.0, 3.0, 0.0], jnp.float32))[0]
    tq = T.state_from_numpy("queue", [np.asarray(x) for x in jax.tree_util.tree_leaves(jq)],
                            device="cpu")
    pkgs = {"jax": (JC, jq, lambda t: t), "torch": (TC, tq, lambda t: {
        k: ([torch.from_numpy(np.asarray(x)) for x in v] if isinstance(v, list) else v)
        for k, v in t.items()})}
    reports = {}
    for name, (C, q, conv) in pkgs.items():
        fs = C.SimFS(tmp_path / name)
        mgr = C.DFCCheckpointManager(fs, 2, prefix="ckpt")
        for step, tree in enumerate(trees[:2]):
            mgr.announce(step % 2, {"step": step})
            assert mgr.combine(conv(tree), extra_meta={"step": step}) == [step % 2]
        mgr.announce(0, {"step": 9})
        mgr.announce(1, {"step": 10})
        mgr.combine_structure(q, extra_meta={"donor": 1})
        mgr.announce(0, {"step": 11})  # pending at the crash: LOST
        state, report = C.DFCCheckpointManager(fs.crash(), 2, prefix="ckpt").recover()
        reports[name] = (report, [np.asarray(x).tobytes() for x in state])
        rfs = C.SimFS(tmp_path / f"{name}_fwd")
        rmgr = C.DFCCheckpointManager(rfs, 1)
        rmgr.announce(0, {"step": 1})
        reports[name + "_fwd"] = rmgr.recover(lambda: conv(trees[2]))[1]
    assert reports["jax"] == reports["torch"]
    assert reports["jax_fwd"] == reports["torch_fwd"]
    assert reports["torch"][0] == {0: {"committed": False, "step": 11},
                                   1: {"committed": True, "step": 10}}
    for a, b in (("jax", "torch"), ("jax_fwd", "torch_fwd")):
        assert durable_digest(tmp_path / a) == durable_digest(tmp_path / b)
    for src in ("jax", "torch"):
        jstate, jman = JC.DFCCheckpointManager(JC.SimFS(tmp_path / src), 2,
                                               prefix="ckpt").load_structure()
        tstate, tman = TC.DFCCheckpointManager(TC.SimFS(tmp_path / src), 2,
                                               prefix="ckpt").load_structure(device="cpu")
        assert jman == tman and tman["meta"]["committed_ends"] == [0, 2]
        for a, b in zip(jax.tree_util.tree_leaves(jstate), T.state_to_numpy(tstate)):
            assert_same(np.asarray(a), b)
        assert isinstance(tstate, T.QueueState)
    with pytest.raises(ValueError, match="combine_structure"):
        TC.DFCCheckpointManager(TC.SimFS(tmp_path / "jax_fwd"), 1).load_structure(
            device="cpu")
