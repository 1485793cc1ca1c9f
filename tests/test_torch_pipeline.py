"""The port's pipelined durable fabric against the JAX package's, on the CPU.

Depth 2 and 3, with chain 1 and chain = threads, must write the same
durable root (``durable_digest``) with the same per-tag pwb/pfence counts
as the reference; the announce depth guard must retire an in-flight chain
exactly where the reference does; ``MultiThreadDriver`` must dispatch in
the reference's order for the same seed; a crash sweep of the pipelined
path must give the same verdicts -- in-flight predecessors (``prev``)
included -- from either package's recovery of either package's root, and
replay must apply every op exactly once.  The traffic driver must print the
reference example's pwb/op and pfence/op.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.obs.trace import durable_digest  # noqa: E402
from repro.runtime import announce_driver as JD  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.launch import serve_shards  # noqa: E402
from repro_torch.runtime import announce_driver as TD  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
CAP, LANES, THREADS = 256, 16, 3
MIXED = ["deque", "map", "queue", "stack"] * 2
RINGS = ["queue", "stack", "deque"]
NOPS = {"stack": 3, "queue": 3, "deque": 5, "map": 5}
PUSH = {"stack": T.OP_PUSH, "queue": T.OP_ENQ, "deque": T.OP_PUSHR}

JAXPKG = types.SimpleNamespace(fs=JC.SimFS, inj=JC.FaultInjector, crash=JC.CrashNow,
                               rt=JS.ShardedDFCRuntime, drv=JD.MultiThreadDriver,
                               kw={"backend": "ref"})
TORCHPKG = types.SimpleNamespace(fs=TC.SimFS, inj=TC.FaultInjector, crash=TC.CrashNow,
                                 rt=TS.ShardedDFCRuntime, drv=TD.MultiThreadDriver,
                                 kw={"device": "cpu"})


def _batch(rng, kinds, n):
    keys = rng.integers(0, 1000, n)
    shard = TS.shard_of_keys_host(keys, len(kinds))
    ops = rng.integers(0, np.asarray([NOPS[kinds[s]] for s in shard]))
    params = rng.integers(1, 60, n).astype(np.float32)
    return keys, ops, params


def _rounds(seed, kinds, n_rounds, n_threads, per):
    rng = np.random.default_rng(seed)
    return [[_batch(rng, kinds, per) for _ in range(n_threads)] for _ in range(n_rounds)]


def _lockstep(rt, rounds):
    """Every thread announces round r's batch (token r+1), then one
    ``combine_phase``; a final ``flush``."""
    for r, batches in enumerate(rounds):
        for t, (keys, ops, params) in enumerate(batches):
            rt.announce(t, keys, ops, params, token=r + 1)
        rt.combine_phase()
    rt.flush()


def _fabric(pkg, root, depth, chain, kinds=MIXED, n_threads=THREADS, crash_at=None):
    inj = pkg.inj(crash_at=crash_at)
    fs = pkg.fs(root, inj)
    rt = pkg.rt(kinds, len(kinds), CAP, LANES, fs=fs, n_threads=n_threads,
                depth=depth, chain=chain, **pkg.kw)
    return rt, fs, inj


@pytest.mark.parametrize("depth,chain", [(2, 1), (2, THREADS), (3, 1), (3, THREADS)])
def test_pipelined_path_matches_jax(tmp_path, depth, chain):
    rounds = _rounds(depth * 10 + chain, MIXED, 4, THREADS, 8)
    out = {}
    for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
        rt, fs, _ = _fabric(pkg, tmp_path / name, depth, chain)
        _lockstep(rt, rounds)
        out[name] = (rt, fs)
    (jrt, jfs), (trt, tfs) = out["j"], out["t"]
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")
    assert jfs.pstats.as_dict() == tfs.pstats.as_dict() and jfs.stats == tfs.stats
    for t in range(THREADS):
        for tok in (3, 4):
            assert jrt.read_responses(t, token=tok) == trt.read_responses(t, token=tok)
    for s in range(len(MIXED)):
        assert jrt.shard_contents(s) == trt.shard_contents(s)
    assert not trt._inflight


def test_announce_depth_guard_retires_in_flight_chain(tmp_path):
    """Depth 3 keeps two chains in flight; a thread's third announcement
    reuses the slot of its first batch, still in flight, so the guard
    retires that chain first -- in both packages, at the same op."""
    rng = np.random.default_rng(9)
    batches = [_batch(rng, MIXED, 6) for _ in range(3)]
    seen = {}
    for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
        rt, fs, _ = _fabric(pkg, tmp_path / name, 3, 1, n_threads=1)
        for tok, (keys, ops, params) in enumerate(batches[:2], start=1):
            rt.announce(0, keys, ops, params, token=tok)
            rt.combine_phase()
        assert len(rt._inflight) == 2 and rt.read_responses(0, token=1) is None
        resp_writes = fs.pstats.pwb.get("resp", 0)
        rt.announce(0, *batches[2], token=3)
        assert len(rt._inflight) == 1  # token 1's chain retired first
        assert fs.pstats.pwb["resp"] == resp_writes + 1
        assert rt.read_responses(0, token=2) is None  # still in flight
        seen[name] = (fs.pstats.as_dict(), dict(fs.stats))
        rt.combine_phase()
        rt.flush()
    assert seen["j"] == seen["t"]
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")


@pytest.mark.parametrize("depth", [1, 2])
def test_multithread_driver_matches_jax(tmp_path, depth):
    """Same seed, same submissions: the same announce/combine interleaving,
    dispatch order, durable root and responses."""
    rng = np.random.default_rng(20 + depth)
    subs = [[_batch(rng, MIXED, 5) for _ in range(3)] for _ in range(THREADS)]
    out = {}
    for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
        rt, fs, _ = _fabric(pkg, tmp_path / name, depth, THREADS)
        drv = pkg.drv(rt, seed=4)
        toks = [[drv.submit(t, *b) for b in subs[t]] for t in range(THREADS)]
        trace = drv.run()
        out[name] = (trace, drv.dispatch_order, dict(fs.stats), fs.pstats.as_dict(),
                     [drv.responses(t, toks[t][-1]) for t in range(THREADS)])
    assert out["j"] == out["t"]
    assert any(a[0] == "combine" and len(a[1]) > 1 for a in out["t"][0])
    assert durable_digest(tmp_path / "j") == durable_digest(tmp_path / "t")


def _verdicts(report):
    def ops(vs):
        return [(v.applied, v.kind, v.resp, v.shard) for v in vs]

    return {
        t: (r["token"], ops(r["ops"]),
            None if r["prev"] is None else (r["prev"]["token"], ops(r["prev"]["ops"])))
        for t, r in report.items()
    }


def _contents(rt):
    return sorted(sum((rt.shard_contents(s) for s in range(rt.n_shards)), []))


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_crash_sweep_prev_verdicts_cross_recovery(tmp_path, depth):
    """Chain = threads, insert-only: crash both packages at the same
    persistence ops; same roots; the same verdicts (in-flight predecessors
    included) whichever package recovers whichever root; the port's replay
    + re-drive applies every op exactly once."""
    kinds, chain = RINGS, THREADS
    rng = np.random.default_rng(31)
    val = 1.0
    rounds = []
    for _ in range(4):
        batches = []
        for _ in range(THREADS):
            keys = rng.integers(0, 1000, 3)
            ops = np.asarray([PUSH[kinds[s]] for s in TS.shard_of_keys_host(keys, 3)])
            batches.append((keys, ops, np.arange(val, val + 3, dtype=np.float32)))
            val += 3
        rounds.append(batches)
    everything = sorted(float(p) for b in sum(rounds, []) for p in b[2])
    rt, fs, inj = _fabric(TORCHPKG, tmp_path / "dry", depth, chain, kinds)
    _lockstep(rt, rounds)
    total = inj.count
    saw_prev = False
    for k in range(3, total, max(1, total // 14)):
        for name, pkg in (("j", JAXPKG), ("t", TORCHPKG)):
            rt, fs, _ = _fabric(pkg, tmp_path / f"{name}{k}", depth, chain, kinds,
                                crash_at=k)
            with pytest.raises(pkg.crash):
                _lockstep(rt, rounds)
        assert durable_digest(tmp_path / f"j{k}") == durable_digest(tmp_path / f"t{k}")
        for src in ("j", "t"):
            shutil.copytree(tmp_path / f"{src}{k}", tmp_path / f"{src}{k}_byj")
            shutil.copytree(tmp_path / f"{src}{k}", tmp_path / f"{src}{k}_byt")
        for src in ("j", "t"):
            jrec, jrep = JAXPKG.rt.recover(
                JC.SimFS(tmp_path / f"{src}{k}_byj"), kind=kinds, n_shards=3,
                capacity=CAP, lanes=LANES, n_threads=THREADS, depth=depth, chain=chain,
                backend="ref")
            trec, trep = TORCHPKG.rt.recover(
                TC.SimFS(tmp_path / f"{src}{k}_byt"), kind=kinds, n_shards=3,
                capacity=CAP, lanes=LANES, n_threads=THREADS, depth=depth, chain=chain,
                device="cpu")
            assert _verdicts(jrep) == _verdicts(trep)
            assert _contents(jrec) == _contents(trec)
        saw_prev |= any(r["prev"] is not None for r in trep.values())
        assert jrec.replay_pending(jrep) == trec.replay_pending(trep)
        assert _contents(jrec) == _contents(trec)
        surfaced = {t: trep[t]["token"] or 0 for t in range(THREADS)}
        for r, batches in enumerate(rounds):
            for t, b in enumerate(batches):
                if r + 1 > surfaced[t]:
                    trec.announce(t, *b, token=r + 1)
            trec.combine_phase()
        trec.flush()
        assert _contents(trec) == everything, k
    assert saw_prev  # the sweep crossed an in-flight predecessor


def _pwb_line(text):
    return re.findall(r"pwb/op: [0-9.]+ +pfence/op: [0-9.]+", text)[-1]


@pytest.mark.parametrize("depth", [[], ["--depth", "3"]])
def test_serve_shards_durable_matches_reference_example(depth):
    """``--mixed --durable --threads 4`` runs the reference example's
    schedule (the seeded multi-thread driver): the same pwb/op and
    pfence/op as ``examples/serve_shards.py``."""
    argv = ["--mixed", "--durable", "--shards", "4", "--batch", "32", "--phases", "6",
            "--threads", "4", *depth]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "examples/serve_shards.py", *argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_shards.serve(serve_shards.build_parser().parse_args(
            argv + ["--device", "cpu"]))
    assert _pwb_line(buf.getvalue()) == _pwb_line(ref.stdout)
    assert out["n_ops"] == 32 * 6 and out["rt"].depth == (3 if depth else 1)
