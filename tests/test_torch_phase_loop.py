"""The port's fused phase loop against the JAX package's, on the CPU.

``hetero_phase_loop_step`` over a mixed fabric must give the same bytes on
both phase axes (responses, kinds, per-phase states, re-based intents, the
new meta).  ``ShardedDFCRuntime.phase_loop`` must return the same records
and write the same durable root (``durable_digest``, per-tag pwb/pfence)
as JAX's ``phase_loop`` and as the port's serial drive.  A crash sweep over
the intent drain must give the same roots and verdicts in both packages,
each package recovering the other's root, and replay must apply every op
exactly once.
"""

import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.obs.trace import durable_digest  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CAP, LANES = 256, 16
MIXED = ["deque", "map", "queue", "stack"] * 2
RINGS = ["queue", "stack", "deque"]
NOPS = {"stack": 3, "queue": 3, "deque": 5, "map": 5}
PUSH = {"stack": T.OP_PUSH, "queue": T.OP_ENQ, "deque": T.OP_PUSHR}
# the JAX backend each phase axis runs on (its grid needs Pallas)
JAX_BACKEND = {"scan": "ref", "grid": "pallas"}

JAXPKG = types.SimpleNamespace(fs=JC.SimFS, inj=JC.FaultInjector, crash=JC.CrashNow,
                               rt=JS.ShardedDFCRuntime, kw=lambda axis: {
                                   "backend": JAX_BACKEND[axis]})
TORCHPKG = types.SimpleNamespace(fs=TC.SimFS, inj=TC.FaultInjector, crash=TC.CrashNow,
                                 rt=TS.ShardedDFCRuntime,
                                 kw=lambda axis: {"device": "cpu"})


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def _state_same(jstate, tstate, what):
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jstate),
                                   T.state_to_numpy(tstate))):
        assert_same(np.asarray(a), b, f"{what} leaf {i}")


def _mixed_schedule(seed, kinds, n_rounds, n_threads, per_thread):
    """[(thread, token, keys, ops, params)], one phase per entry, round-major;
    op codes valid for each key's shard (OP_NONE lanes included)."""
    rng = np.random.default_rng(seed)
    sched = []
    for r in range(n_rounds):
        for t in range(n_threads):
            keys = rng.integers(0, 1000, per_thread)
            shard = TS.shard_of_keys_host(keys, len(kinds))
            ops = rng.integers(0, np.asarray([NOPS[kinds[s]] for s in shard]))
            params = rng.integers(1, 60, per_thread).astype(np.float32)
            sched.append((t, r + 1, [int(k) for k in keys], [int(o) for o in ops],
                          [float(p) for p in params]))
    return sched


def _insert_schedule(seed, kinds, n_rounds, n_threads, per_thread):
    """Insert-only schedule with globally unique params (exactly-once is
    then a multiset check)."""
    rng = np.random.default_rng(seed)
    sched, val = [], 1.0
    for r in range(n_rounds):
        for t in range(n_threads):
            keys = [int(k) for k in rng.integers(0, 1000, per_thread)]
            ops = [PUSH[kinds[s]] for s in TS.shard_of_keys_host(keys, len(kinds))]
            sched.append((t, r + 1, keys, ops, [val + i for i in range(per_thread)]))
            val += per_thread
    return sched


@pytest.mark.parametrize("axis", ["scan", "grid"])
def test_hetero_phase_loop_step_matches_jax(axis):
    rng = np.random.default_rng(3)
    k_phases, width, n_shards = 4, 24, len(MIXED)
    keys = rng.integers(0, 1000, (k_phases, width)).astype(np.int32)
    shard = TS.shard_of_keys_host(keys, n_shards)
    ops = rng.integers(0, np.asarray([NOPS[k] for k in MIXED])[shard]).astype(np.int32)
    params = rng.integers(1, 60, (k_phases, width)).astype(np.float32)
    ops[1] = T.OP_NONE  # a pass-through phase
    table = np.arange(n_shards, dtype=np.int32)
    jmeta = {k: jnp.asarray(v) for k, v in JS._init_meta(MIXED).items()}
    jmeta["phases"] = jmeta["phases"] + 3  # a non-zero durable baseline
    tmeta = TS._init_meta(MIXED, "cpu")
    tmeta["phases"] = tmeta["phases"] + 3
    jg = {k: JS.init_sharded(k, 2, CAP) for k in set(MIXED)}
    tg = {k: T.init_sharded(k, 2, CAP, device="cpu") for k in set(MIXED)}
    jout = JS.hetero_phase_loop_step(
        jg, jnp.asarray(table), jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(params),
        jmeta, kinds=tuple(MIXED), lanes=LANES, backend=JAX_BACKEND[axis],
        phase_axis=axis, donate=False)
    tout = TS.hetero_phase_loop_step(
        tg, torch.from_numpy(table), torch.from_numpy(keys), torch.from_numpy(ops),
        torch.from_numpy(params), tmeta, kinds=tuple(MIXED), lanes=LANES,
        phase_axis=axis, unroll=2, donate=True)
    for k in jg:
        _state_same(jout[0][k], tout[0][k], f"new {k}")
        _state_same(jout[4][k], tout[4][k], f"states {k}")
    for col in ("phases", "ops_combined", "kind"):
        assert_same(np.asarray(jout[1][col]), tout[1][col].numpy(), col)
    for i in (2, 3, 5):
        assert_same(np.asarray(jout[i]), tout[i].numpy(), f"output {i}")
    for f in ("epoch", "touched", "phases_cum", "ops_cum"):
        assert_same(np.asarray(getattr(jout[6], f)), getattr(tout[6], f).numpy(), f)


def _phase_loop(pkg, root, sched, axis, kinds=MIXED, n_threads=2, crash_at=None):
    inj = pkg.inj(crash_at=crash_at)
    fs = pkg.fs(root, inj)
    rt = pkg.rt(kinds, len(kinds), CAP, LANES, fs=fs, n_threads=n_threads,
                **pkg.kw(axis))
    try:
        return rt, fs, rt.phase_loop(sched, phase_axis=axis), inj.count
    except pkg.crash:
        return rt, fs, None, inj.count


@pytest.mark.parametrize("axis", ["scan", "grid"])
def test_phase_loop_matches_jax_and_serial_drive(tmp_path, axis):
    """Same schedule: identical records, durable root and per-tag counts in
    both packages, equal to the port's serial drive of it (chain = threads,
    so each announcement is its own phase)."""
    sched = _mixed_schedule(4, MIXED, 3, 2, 10)
    jrt, jfs, jrec, _ = _phase_loop(JAXPKG, tmp_path / "j", sched, axis)
    trt, tfs, trec, _ = _phase_loop(TORCHPKG, tmp_path / "t", sched, axis)
    assert jrec == trec
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")
    assert jfs.pstats.as_dict() == tfs.pstats.as_dict() and jfs.stats == tfs.stats
    for k in jrt.groups:
        _state_same(jrt.groups[k], trt.groups[k], k)
    for t in range(2):
        assert jrt.read_responses(t) == trt.read_responses(t)

    sfs = TC.SimFS(tmp_path / "serial")
    srt = TS.ShardedDFCRuntime(MIXED, len(MIXED), CAP, LANES, fs=sfs, n_threads=2,
                               chain=2, device="cpu")
    serial = []
    for tok in (1, 2, 3):
        entries = [e for e in sched if e[1] == tok]
        for t, tk, k, o, p in entries:
            srt.announce(t, k, o, p, token=tk)
        srt.combine_phase()
        srt.flush()
        serial += [srt.read_responses(t, token=tk) for t, tk, *_ in entries]
    assert sfs.stats == tfs.stats and sfs.pstats.as_dict() == tfs.pstats.as_dict()
    assert durable_digest(tmp_path / "serial") == durable_digest(tmp_path / "t")
    for rec, want in zip(trec, serial):
        assert {k: rec[k] for k in want} == want
    for s in range(len(MIXED)):
        assert srt.shard_contents(s) == trt.shard_contents(s)


def _verdicts(report):
    return {
        t: (r["token"], [(v.applied, v.kind, v.resp, v.shard) for v in r["ops"]],
            None if r["prev"] is None else r["prev"]["token"])
        for t, r in report.items()
    }


def _contents(rt):
    return sorted(sum((rt.shard_contents(s) for s in range(rt.n_shards)), []))


@pytest.mark.parametrize("axis", ["scan", "grid"])
def test_phase_loop_crash_sweep_cross_recovery_exactly_once(tmp_path, axis):
    """Crash both packages' intent drains at the same persistence op:
    identical roots; either package's recovery of either root gives the
    same verdicts and state; replay + re-drive lands every op once."""
    kinds, n_threads = RINGS, 2
    sched = _insert_schedule(8, kinds, 2, n_threads, 3)
    *_, total = _phase_loop(TORCHPKG, tmp_path / "dry", sched, axis, kinds, n_threads)
    assert total > 40
    for k in range(1, total, max(1, total // 9)):
        roots = {}
        for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
            rt, _, rec, _ = _phase_loop(pkg, tmp_path / f"{name}{k}", sched, axis,
                                        kinds, n_threads, crash_at=k)
            assert rec is None
            roots[name] = tmp_path / f"{name}{k}"
        assert durable_digest(roots["j"]) == durable_digest(roots["t"])
        for src in ("j", "t"):
            shutil.copytree(roots[src], tmp_path / f"{src}{k}_byj")
            shutil.copytree(roots[src], tmp_path / f"{src}{k}_byt")
        for src in ("j", "t"):
            jrec, jrep = JAXPKG.rt.recover(
                JC.SimFS(tmp_path / f"{src}{k}_byj"), kind=kinds, n_shards=len(kinds),
                capacity=CAP, lanes=LANES, n_threads=n_threads, backend=JAX_BACKEND[axis])
            trec, trep = TORCHPKG.rt.recover(
                TC.SimFS(tmp_path / f"{src}{k}_byt"), kind=kinds, n_shards=len(kinds),
                capacity=CAP, lanes=LANES, n_threads=n_threads, device="cpu")
            assert _verdicts(jrep) == _verdicts(trep)
            assert _contents(jrec) == _contents(trec)
        # exactly once on the port's own root: replay, then re-drive the
        # phases whose announce never became durable
        applied = set(_contents(trec))
        for t, r in trep.items():
            for rec in ([r] if r["token"] is not None else []) + (
                    [r["prev"]] if r.get("prev") else []):
                params = next(e[4] for e in sched if e[:2] == (t, rec["token"]))
                assert all(params[i] in applied for i, v in enumerate(rec["ops"])
                           if v.applied)
        trec.replay_pending(trep)
        surfaced = {t: trep[t]["token"] or 0 for t in range(n_threads)}
        rest = [e for e in sched if e[1] > surfaced[e[0]]]
        if rest:
            trec.phase_loop(rest, phase_axis=axis)
        assert _contents(trec) == sorted(p for e in sched for p in e[4]), k


def test_phase_loop_empty_and_pending_drain(tmp_path):
    """An empty schedule writes nothing; a pending announcement is combined
    and retired before the fused loop starts, as in the reference."""
    outs = {}
    sched = _insert_schedule(1, ["queue", "stack"], 1, 1, 3)
    for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
        fs = pkg.fs(tmp_path / name)
        rt = pkg.rt(["queue", "stack"], 2, CAP, LANES, fs=fs, n_threads=2,
                    **pkg.kw("scan"))
        assert rt.phase_loop([]) == [] and fs.stats == {"pwb": 0, "pfence": 0}
        rt.announce(1, [5, 6], [T.OP_ENQ, T.OP_PUSH], [100.0, 101.0], token=1)
        outs[name] = (rt.phase_loop(sched), rt.read_responses(1))
    assert outs["j"] == outs["t"]
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")
