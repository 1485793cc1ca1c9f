"""The port's ``ShardedDFCRuntime`` against the JAX one, on the CPU.

Volatile ``step`` over homogeneous and mixed fabrics must give the same
bytes (responses, kinds, every state leaf, the meta counters).  The serial
durable path with several announcing threads must write the same durable
root: the same ``durable_digest``, the same per-tag pwb/pfence counts, the
same ``read_responses``.  A crash sweep over persistence-op indices must
give the same recovery verdicts and shard contents in both packages, with
each package recovering roots the other wrote, and ``replay_pending`` must
then reach the sequential oracle with every op applied exactly once.
"""

import contextlib
import io
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.obs.trace import durable_digest  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.launch import serve_shards  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

S, CAP, LANES, THREADS, B = 8, 128, 12, 3, 8
MIXED = ["deque", "map", "queue", "stack"] * 2
NOPS = {"stack": 3, "queue": 3, "deque": 5, "map": 5}

JAXPKG = types.SimpleNamespace(fs=JC.SimFS, inj=JC.FaultInjector, crash=JC.CrashNow,
                               rt=JS.ShardedDFCRuntime, kw={"backend": "ref"})
TORCHPKG = types.SimpleNamespace(fs=TC.SimFS, inj=TC.FaultInjector, crash=TC.CrashNow,
                                 rt=TS.ShardedDFCRuntime, kw={"device": "cpu"})


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def assert_fabric_same(jrt, trt):
    assert sorted(jrt.groups) == sorted(trt.groups)
    for k in jrt.groups:
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jrt.groups[k]),
                                       T.state_to_numpy(trt.groups[k]))):
            assert_same(np.asarray(a), b, f"{k} leaf {i}")
    for col in ("phases", "ops_combined", "kind"):
        assert_same(np.asarray(jrt.meta[col]), trt.meta[col].numpy(), col)


def _phase_batch(rng, kinds, n, table_shards):
    keys = rng.integers(0, 1000, n)
    shard = TS.shard_of_keys_host(keys, table_shards)
    opmax = np.asarray([NOPS[kinds[s]] for s in range(table_shards)])
    ops = rng.integers(0, opmax[shard])  # OP_NONE lanes included
    params = (rng.random(n) * 100).round(2).astype(np.float32)  # f32 payloads
    cas =(ops == T.OP_MAP_CAS) & np.asarray([kinds[s] == "map" for s in shard])
    params[cas] = rng.integers(0, 30, int(cas.sum())) * T.CAS_DOM + 5
    return keys, ops, params


@pytest.mark.parametrize("kind", ["stack", "queue", "deque", "map", "mixed"])
def test_step_matches_jax(kind):
    """Volatile phases: port (kernel backend, its plain twins on the CPU)
    against JAX ``ref``, and port ``torch`` against JAX ``jnp``."""
    kinds = MIXED if kind == "mixed" else [kind] * S
    rng = np.random.default_rng(len(kind))
    pairs = [
        (JS.ShardedDFCRuntime(kinds, S, CAP, LANES, backend="ref"),
         TS.ShardedDFCRuntime(kinds, S, CAP, LANES, device="cpu")),
        (JS.ShardedDFCRuntime(kinds, S, CAP, LANES, backend="jnp"),
         TS.ShardedDFCRuntime(kinds, S, CAP, LANES, backend="torch", device="cpu")),
    ]
    for _ in range(4):
        keys, ops, params = _phase_batch(rng, kinds, 48, S)
        for jrt, trt in pairs:
            jr, jk = jrt.step(keys, ops, params)
            tr, tk = trt.step(keys, ops, params)
            assert_same(np.asarray(jr), tr.numpy(), "resp")
            assert_same(np.asarray(jk), tk.numpy(), "kinds")
            assert_fabric_same(jrt, trt)
    for s in range(S):
        assert pairs[0][0].shard_contents(s) == pairs[0][1].shard_contents(s)
    np.testing.assert_array_equal(pairs[0][0].shard_sizes(), pairs[0][1].shard_sizes())


def test_sharded_step_and_multi_step_match_jax():
    """The fused entry points: homogeneous ``sharded_step`` and the chained
    ``hetero_multi_step`` (with an all-OP_NONE pass-through batch), every
    output of their tuples."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    keys, ops, params = _phase_batch(rng, ["queue"] * S, 40, S)
    jmeta = {k: jnp.asarray(v) for k, v in JS._init_meta(["queue"] * S).items()}
    tmeta = TS._init_meta(["queue"] * S, "cpu")
    j = JS.sharded_step(JS.init_sharded("queue", S, CAP), jnp.asarray(keys),
                        jnp.asarray(ops, jnp.int32), jnp.asarray(params, jnp.float32),
                        jmeta, kind="queue", n_shards=S, lanes=LANES, backend="ref")
    t = TS.sharded_step(T.init_sharded("queue", S, CAP, device="cpu"),
                        torch.from_numpy(keys), torch.from_numpy(ops.astype(np.int32)),
                        torch.from_numpy(params), tmeta, kind="queue", n_shards=S,
                        lanes=LANES)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(j[0]),
                                   T.state_to_numpy(t[0]))):
        assert_same(np.asarray(a), b, f"leaf {i}")
    for col in ("phases", "ops_combined"):
        assert_same(np.asarray(j[1][col]), t[1][col].numpy(), col)
    assert_same(np.asarray(j[2]), t[2].numpy())
    assert_same(np.asarray(j[3]), t[3].numpy())

    batches = [_phase_batch(rng, MIXED, 32, S) for _ in range(3)]
    k3 = np.stack([b[0] for b in batches]).astype(np.int32)
    o3 = np.stack([b[1] for b in batches]).astype(np.int32)
    p3 = np.stack([b[2] for b in batches])
    o3[1] = T.OP_NONE
    jgroups = {k: JS.init_sharded(k, 2, CAP) for k in set(MIXED)}
    tgroups = {k: T.init_sharded(k, 2, CAP, device="cpu") for k in set(MIXED)}
    jmeta = {k: jnp.asarray(v) for k, v in JS._init_meta(MIXED).items()}
    table = np.arange(S, dtype=np.int32)
    jout = JS.hetero_multi_step(jgroups, jnp.asarray(table), jnp.asarray(k3),
                                jnp.asarray(o3), jnp.asarray(p3), jmeta,
                                kinds=tuple(MIXED), lanes=LANES, backend="ref")
    tout = TS.hetero_multi_step(tgroups, torch.from_numpy(table), torch.from_numpy(k3),
                                torch.from_numpy(o3), torch.from_numpy(p3),
                                TS._init_meta(MIXED, "cpu"), kinds=tuple(MIXED),
                                lanes=LANES)
    for k in jgroups:
        for a, b in zip(jax.tree_util.tree_leaves(jout[0][k]),
                        T.state_to_numpy(tout[0][k])):
            assert_same(np.asarray(a), b, f"new {k}")
        for a, b in zip(jax.tree_util.tree_leaves(jout[4][k]),
                        T.state_to_numpy(tout[4][k])):
            assert_same(np.asarray(a), b, f"states {k}")
    for col in ("phases", "ops_combined", "kind"):
        assert_same(np.asarray(jout[1][col]), tout[1][col].numpy(), col)
    for i in (2, 3, 5, 6, 7, 8):
        assert_same(np.asarray(jout[i]), tout[i].numpy(), f"output {i}")
    assert_same(np.asarray(jout[6][0]), np.asarray(jout[6][1]))  # pass-through


def _schedule(seed, n_phases=3, kinds=MIXED):
    rng = np.random.default_rng(seed)
    return [[_phase_batch(rng, kinds, B, S) for _ in range(THREADS)]
            for _ in range(n_phases)]


def _drive(pkg, root, schedule, crash_at=None, kinds=MIXED):
    inj = pkg.inj(crash_at=crash_at)
    fs = pkg.fs(root, inj)
    rt = pkg.rt(kinds, S, CAP, LANES, fs=fs, n_threads=THREADS, **pkg.kw)
    completed = []
    try:
        for p, batches in enumerate(schedule):
            for t, (keys, ops, params) in enumerate(batches):
                rt.announce(t, keys, ops, params, token=p + 1)
            rt.combine_phase()
            completed.append(p)
    except pkg.crash:
        return rt, fs, completed, True, inj.count
    return rt, fs, completed, False, inj.count


def test_durable_path_same_root_counts_and_responses(tmp_path):
    """Same schedule, three announcing threads per phase: identical durable
    root, per-tag pwb/pfence counts and durable response records."""
    sched = _schedule(1, n_phases=4)
    jrt, jfs, _, _, _ = _drive(JAXPKG, tmp_path / "jax", sched)
    trt, tfs, _, _, _ = _drive(TORCHPKG, tmp_path / "torch", sched)
    assert durable_digest(tmp_path / "jax") == durable_digest(tmp_path / "torch")
    assert jfs.pstats.as_dict() == tfs.pstats.as_dict()
    assert jfs.stats == tfs.stats
    for t in range(THREADS):
        assert jrt.read_responses(t) == trt.read_responses(t)
        assert jrt.read_responses(t, token=3) == trt.read_responses(t, token=3)
        with pytest.raises(TS.StaleTokenError):
            trt.read_responses(t, token=1)
    assert_fabric_same(jrt, trt)
    assert jrt.ready_announcements() == trt.ready_announcements() == []


def _verdicts(report):
    return {
        t: (r["token"], [(v.applied, v.kind, v.resp, v.shard) for v in r["ops"]])
        for t, r in report.items()
    }


def _recover(pkg, root):
    return pkg.rt.recover(pkg.fs(root), kind=MIXED, n_shards=S, capacity=CAP,
                          lanes=LANES, n_threads=THREADS, **pkg.kw)


def _oracle_after(schedule, completed, report, trt):
    """Contents the fabric must hold after recovery + replay: the completed
    phases, the interrupted phase on exactly the shards that committed, and
    the replayed batch (read back from the re-announced records)."""
    lists = [{} if k == "map" else [] for k in MIXED]
    for p in completed:
        flat = [np.concatenate([b[i] for b in schedule[p]]) for i in range(3)]
        TS.sequential_hetero_reference(MIXED, lists, flat[0], flat[1].tolist(),
                                       flat[2].tolist(), LANES, capacity=CAP)
    if len(completed) < len(schedule):
        p = len(completed)
        flat = [np.concatenate([b[i] for b in schedule[p]]) for i in range(3)]
        committed = set()
        for t in range(THREADS):
            r = report[t]
            if r["token"] == p + 1:
                ops_t = schedule[p][t][1]
                committed |= {v.shard for v, o in zip(r["ops"], ops_t)
                              if v.kind is not None and o != T.OP_NONE}
        trial = [dict(x) if isinstance(x, dict) else list(x) for x in lists]
        TS.sequential_hetero_reference(MIXED, trial, flat[0], flat[1].tolist(),
                                       flat[2].tolist(), LANES, capacity=CAP)
        for s in committed:
            lists[s] = trial[s]
    replay = [trt._read_ann(t, trt._read_valid(t) & 1)
              for (t, _tok) in (trt.last_dispatch[0] if trt.last_dispatch else ())]
    if replay:
        eresp, ekinds = TS.sequential_hetero_reference(
            MIXED, lists, sum((a["keys"] for a in replay), []),
            sum((a["ops"] for a in replay), []),
            sum((a["params"] for a in replay), []), LANES, capacity=CAP)
        got = sum((a["val"]["kinds"] for a in replay), [])
        assert got == ekinds
        np.testing.assert_array_equal(
            np.asarray(sum((a["val"]["resp"] for a in replay), []), np.float32),
            np.asarray(eresp, np.float32))
    return lists


def test_crash_sweep_cross_recovery_and_exactly_once_replay(tmp_path):
    """Crash both packages at the same persistence op: identical roots,
    identical verdicts from either package's recovery of either root, and
    a replay that applies every announced op exactly once."""
    sched = _schedule(2)
    *_, crashed, total = _drive(TORCHPKG, tmp_path / "dry", sched)
    assert not crashed and total > 100
    for k in range(1, total + 1, 9):
        jrt, jfs, jdone, jc, _ = _drive(JAXPKG, tmp_path / f"j{k}", sched, crash_at=k)
        trt, tfs, tdone, tc, _ = _drive(TORCHPKG, tmp_path / f"t{k}", sched, crash_at=k)
        assert jc and tc and jdone == tdone
        assert durable_digest(tmp_path / f"j{k}") == durable_digest(tmp_path / f"t{k}")
        for src in ("j", "t"):  # each package recovers each package's root
            shutil.copytree(tmp_path / f"{src}{k}", tmp_path / f"{src}{k}_byj")
            shutil.copytree(tmp_path / f"{src}{k}", tmp_path / f"{src}{k}_byt")
        outcomes = []
        for src in ("j", "t"):
            jrec, jrep = _recover(JAXPKG, tmp_path / f"{src}{k}_byj")
            trec, trep = _recover(TORCHPKG, tmp_path / f"{src}{k}_byt")
            assert _verdicts(jrep) == _verdicts(trep)
            assert_fabric_same(jrec, trec)
            outcomes.append((jrec, jrep, trec, trep))
        jrec, jrep, trec, trep = outcomes[1]  # the port's root
        assert jrec.replay_pending(jrep) == trec.replay_pending(trep)
        assert_fabric_same(jrec, trec)
        oracle = _oracle_after(sched, tdone, trep, trec)
        for s in range(S):
            got = trec.shard_contents(s)
            assert (dict(got) if MIXED[s] == "map" else got) == oracle[s], (k, s)


def test_recovered_pending_batch_combines(tmp_path):
    """An announcement published but never combined is re-staged by
    recovery and combined by the next ``combine_phase`` of either package."""
    sched = _schedule(3, n_phases=1)
    outs = {}
    for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
        fs = pkg.fs(tmp_path / name)
        rt = pkg.rt(MIXED, S, CAP, LANES, fs=fs, n_threads=THREADS, **pkg.kw)
        for t, (keys, ops, params) in enumerate(sched[0]):
            rt.announce(t, keys, ops, params, token=1)
        rt2, report = _recover(pkg, tmp_path / name)
        assert all(not v.applied for r in report.values() for v in r["ops"])
        assert rt2.combine_phase() == list(range(THREADS))
        outs[name] = rt2
    assert_fabric_same(outs["j"], outs["t"])
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")


def test_serve_shards_runs_on_cpu():
    """The traffic driver, small, volatile and durable with two threads."""
    for argv in (["--mixed", "--shards", "8", "--batch", "64", "--phases", "3"],
                 ["--mixed", "--shards", "8", "--batch", "64", "--phases", "3",
                  "--durable", "--threads", "2"],
                 ["--kind", "map", "--shards", "4", "--batch", "32", "--phases", "2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = serve_shards.serve(
                serve_shards.build_parser().parse_args(argv + ["--device", "cpu"]))
        text = buf.getvalue()
        assert "throughput:" in text and "phases/shard:" in text
        assert out["n_ops"] + out["n_overflow"] == int(argv[argv.index("--batch") + 1]) * int(
            argv[argv.index("--phases") + 1])
        if "--durable" in argv:
            assert "pwb/op:" in text and out["pwb"] > 0
    assert serve_shards.main(["--shards", "2", "--batch", "8", "--phases", "1",
                              "--device", "cpu"]) == 0


def test_later_slices_raise_and_device_is_explicit(tmp_path):
    """Entry points stay on the card unless asked for the CPU; per-side
    lanes, split/merge and ``--split-backlog`` run; a root that the JAX
    package resharded recovers in the port with its topology and contents."""
    fs = TC.SimFS(tmp_path)
    rt = TS.ShardedDFCRuntime("queue", 2, 16, 4, fs=fs, device="cpu", split_lanes=True,
                              n_buckets=4)
    assert rt.split_lanes and rt.lane_stats() == {"epochs": {0: [0, 0], 1: [0, 0]},
                                                  "backlog": {0: [0, 0], 1: [0, 0]}}
    assert rt.split_shard(0) == 2 and rt.n_shards == 3
    rt.merge_shards(2, 0)
    assert set(rt.table.tolist()) == {0, 1} and rt.r_epoch == 4
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve_shards.serve(serve_shards.build_parser().parse_args(
            ["--shards", "4", "--batch", "32", "--phases", "3", "--split-backlog", "4",
             "--device", "cpu"]))
    assert out["splits"] and out["rt"].n_shards == 4 + len(out["splits"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TS.ShardedDFCRuntime("queue", 2, 16, 4)
    # a root that JAX resharded recovers with the same topology and contents
    jfs = JC.SimFS(tmp_path / "reshard")
    jrt = JS.ShardedDFCRuntime("queue", 2, 16, 4, fs=jfs, n_buckets=4, backend="ref")
    jrt.announce(0, [jrt.key_for_shard(0)] * 2, [T.OP_ENQ] * 2, [1.0, 2.0], token=1)
    jrt.combine_phase()
    jrt.split_shard(0)
    trt, _ = TS.ShardedDFCRuntime.recover(TC.SimFS(tmp_path / "reshard"), kind="queue",
                                          n_shards=2, capacity=16, lanes=4, device="cpu")
    assert (trt.n_shards, trt.kinds, trt.r_epoch) == (3, ["queue"] * 3, 2)
    assert trt.table.tolist() == jrt.table.tolist()
    assert [trt.shard_contents(s) for s in range(3)] == [[1.0, 2.0], [], []]