"""The port's serving tier and launcher against the JAX package's, on the CPU.

The same session schedules through both packages' ``RequestQueueTier``
(FIFO, ``priority`` with front-of-line arrivals, ``k_classes = 3`` weighted
admission; volatile and durable) must give the same admission order, pool
slots, session states, backlog and pwb/op, pfence/op.  A crash sweep of the
durable priority tier must recover the same reconciliation record in both
packages and then serve every session exactly once, highs first.  The
port's launcher must print the reference launcher's summary lines (the
reference run as a subprocess), and serve the same greedy tokens as the
reference model for the same sessions and parameters.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.launch import serve as JV  # noqa: E402
from repro.models.model import decode_step as j_decode_step  # noqa: E402
from repro.models.model import init_params as j_init_params  # noqa: E402
from repro.models.model import prefill as j_prefill  # noqa: E402
from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": (JV.RequestQueueTier, JC, {}),
    "torch": (TV.RequestQueueTier, TC, {"device": "cpu"}),
}
LOWS, HIGHS = [1, 2, 3], [4, 5]


def _snapshot(tier):
    return {
        "queued": tier.queued_sessions(),
        "pool": tier.pool_slots(),
        "sessions": tier.session_states(),
        "progress": tier.session_progress_table(),
        "backlog": tier.backlog(),
        "stats": dict(tier.stats),
        "persist": tier.persistence_stats(),
    }


def _drive(pkg, flavor, durable, root):
    """One schedule through ``pkg``'s tier: arrivals in three rounds
    (priorities or classes per flavor), admissions of 3 with slot release
    and ``mark_served``, progress records, a lookup.  Returns the admission
    log and a state snapshot after each round."""
    cls, ck, kw = PKGS[pkg]
    tier_kw = dict(n_queues=2, slots=3, capacity=512, lanes=16, durable=durable, **kw)
    if durable:
        tier_kw["fs"] = ck.SimFS(root / pkg)
    if flavor == "priority":
        tier_kw["priority"] = True
    if flavor == "k3":
        tier_kw["k_classes"] = 3
    tier = cls(**tier_kw)
    log, snaps = [], []
    rounds = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
    for r, sids in enumerate(rounds):
        extra = {}
        if flavor == "priority":
            extra["priorities"] = [int(s % 3 == 0) for s in sids]
        if flavor == "k3":
            extra["classes"] = [s % 3 for s in sids]
        log.append(("rejected", tier.submit(sids, **extra)))
        admitted = tier.admit(3)
        log.append(("admitted", admitted))
        tier.record_progress({sid: 5 * r + 1 for sid, _ in admitted})
        for sid, _ in admitted[:2]:
            tier.mark_served(sid)
        tier.submit([], release_slots=[slot for _, slot in admitted])
        log.append(("state", tier.session_state(sids[0])))
        snaps.append(_snapshot(tier))
    while tier.backlog():
        admitted = tier.admit(3)
        log.append(("admitted", admitted))
        tier.submit([], release_slots=[slot for _, slot in admitted])
    snaps.append(_snapshot(tier))
    if flavor == "k3":
        log.append(("admit_log", tier.admit_log, tier.starvation_bound()))
    return log, snaps


@pytest.mark.parametrize("durable", [False, True], ids=["volatile", "durable"])
@pytest.mark.parametrize("flavor", ["fifo", "priority", "k3"])
def test_tier_matches_jax(flavor, durable, tmp_path):
    """Admission order, pool, session and progress tables, backlog, counts
    and persistence cost equal the reference tier's on one schedule."""
    want = _drive("jax", flavor, durable, tmp_path)
    got = _drive("torch", flavor, durable, tmp_path)
    assert got == want


def test_weighted_plan_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        k = int(rng.integers(1, 5))
        weights = [int(w) for w in rng.integers(1, 5, k)]
        backlogs = [int(b) for b in rng.integers(0, 6, k)]
        n, cursor = int(rng.integers(0, 12)), int(rng.integers(0, 20))
        assert TS.weighted_cycle(weights) == JS.weighted_cycle(weights)
        assert (TS.weighted_dequeue_plan(backlogs, weights, n, cursor)
                == JS.weighted_dequeue_plan(backlogs, weights, n, cursor))
    for bad in ([], [1, 0]):
        with pytest.raises(ValueError):
            TS.weighted_cycle(bad)


@pytest.mark.parametrize("case", [
    ([1, 2], 2, [1, 2], {1: [(0, 7), (1, 8)], 2: [(1, 9), (0, 3)]}, True),
    ([1, 2], 2, [1, 2, 2], {1: [(0, 7), (1, 8)], 2: [(0, 9), (1, 3)]}, False),
    ([1, 2], 2, [1], {1: [(0, 7), (1, 8)]}, False),
    ([1], 2, [1], {1: [(0, 7), (0, 8)]}, False),
])
def test_verify_exactly_once_matches_jax(case):
    sids, gen, served, entries, ok = case
    for fn in (JV.verify_exactly_once, TV.verify_exactly_once):
        if ok:
            fn(sids, gen, served, entries)
        else:
            with pytest.raises(AssertionError):
                fn(sids, gen, served, entries)


# ------------------------------------------------------------ crash sweep
def _drive_priority(pkg, fs, served):
    """Lows then highs through a 2-slot durable priority tier, drained;
    admitted sids append to ``served`` as they are admitted."""
    cls, _, kw = PKGS[pkg]
    tier = cls(n_queues=1, slots=2, capacity=512, lanes=16, durable=True, fs=fs,
               priority=True, **kw)
    tier.submit(LOWS)
    tier.submit(HIGHS, priorities=[1] * len(HIGHS))
    for _ in range(32):
        admitted = tier.admit(2)
        served += [sid for sid, _ in admitted]
        tier.submit([], release_slots=[slot for _, slot in admitted])
        if tier.backlog() == 0:
            break


def _recover_and_finish(pkg, fs, served):
    """Recover, reconcile as the launcher does, and drain; returns the
    recovery record (minus the raw report) and the final service order."""
    cls, _, kw = PKGS[pkg]
    tier, info = cls.recover(fs, n_queues=1, capacity=512, lanes=16, priority=True, **kw)
    record = {k: v for k, v in info.items() if k != "report"}
    served = served + [s for s in info["in_flight"] if s not in served]
    accounted = set(served) | set(info["queued"])
    missing = [s for s in LOWS + HIGHS if s not in accounted]
    if missing:
        tier.submit(missing, priorities=[int(s in HIGHS) for s in missing])
    pool = tier.pool_slots()
    free = [i for i in range(2) if i not in set(pool)][: 2 - len(pool)]
    if free:
        tier.submit([], release_slots=free)
    for _ in range(32):
        admitted = tier.admit(2)
        served += [sid for sid, _ in admitted if sid not in served]
        tier.submit([], release_slots=[slot for _, slot in admitted])
        if tier.backlog() == 0:
            break
    return record, served


def test_priority_crash_sweep_exactly_once_matches_jax(tmp_path):
    """Crash the durable priority tier at a handful of persistence ops in
    both packages: the same recovery record, and after reconciliation every
    session served exactly once with every high ahead of every low."""
    dry = TC.SimFS(tmp_path / "dry", TC.FaultInjector())
    order = []
    _drive_priority("torch", dry, order)
    assert order == [5, 4, 1, 2, 3]
    total = dry.injector.count
    assert total > 40
    for k in sorted({total // 5, total // 3, total // 2, 2 * total // 3, total - 1}):
        results = {}
        for pkg, (_, ck, _) in PKGS.items():
            fs = ck.SimFS(tmp_path / f"{pkg}{k}", ck.FaultInjector(crash_at=k))
            served = []
            with pytest.raises(ck.CrashNow):
                _drive_priority(pkg, fs, served)
            results[pkg] = (served, *_recover_and_finish(pkg, fs.crash(), served))
        assert results["torch"] == results["jax"], k
        _, _, final = results["torch"]
        assert sorted(final) == sorted(LOWS + HIGHS) and len(final) == len(set(final)), k
        assert max(final.index(h) for h in HIGHS) < min(final.index(lo) for lo in LOWS), k


def test_later_slice_options_raise():
    """Per-side lanes and autosplit build a working tier and the launcher
    takes their flags; so it does ``--window`` (rolling-window decode, held
    against the reference in ``tests/test_torch_hybrid.py``)."""
    tier = TV.RequestQueueTier(split_lanes=True, reshard_backlog=4, device="cpu")
    assert tier.split_lanes and tier.reshard_backlog == 4
    tier.submit(list(range(1, 9)))
    assert tier.stats["splits"] == 1 and tier.rt.n_shards == 7
    with pytest.raises(ValueError, match="k_classes"):
        TV.RequestQueueTier(k_classes=3, reshard_backlog=4, device="cpu")
    for flags in (["--split-lanes"], ["--reshard-backlog", "4"]):
        args = TV.build_parser().parse_args(
            ["--arch", "smollm-135m", "--reduced", "--tier-only", "--device", "cpu",
             "--sessions", "8", *flags])
        with contextlib.redirect_stdout(io.StringIO()):
            assert TV.serve(args)["completed"] == 8
    args = TV.build_parser().parse_args(
        ["--arch", "smollm-135m", "--reduced", "--tier-only", "--device", "cpu",
         "--sessions", "4", "--window", "16"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert TV.serve(args)["completed"] == 4
    # the continuous server and the flight recorder are ported: they run
    args = TV.build_parser().parse_args(
        ["--arch", "smollm-135m", "--reduced", "--tier-only", "--device", "cpu",
         "--sessions", "4", "--k-classes", "3", "--trace"])
    with contextlib.redirect_stdout(io.StringIO()):
        out = TV.serve(args)
    assert out["completed"] == 4 and out["obs"].enabled


# ---------------------------------------------------------------- launcher
def _summary(text):
    """The launcher's report lines with wall-clock times and temp paths cut."""
    out = []
    for line in text.splitlines():
        line = re.sub(r" tok in \d+ ms.*", " tok", line)
        line = re.sub(r"durable under \S+; resume with --resume --state-dir \S+",
                      "durable under DIR", line)
        if not line.startswith("model:"):
            out.append(line)
    return out


def _run_both(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref_argv = [a.replace("STATE", str(tmp_path / "jax")) for a in argv]
    port_argv = [a.replace("STATE", str(tmp_path / "torch")) for a in argv]
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *ref_argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TV.main(port_argv + ["--device", "cpu"])
    return _summary(buf.getvalue()), _summary(ref.stdout)


BASE = ["--arch", "smollm-135m", "--reduced", "--tier-only", "--sessions", "12"]


@pytest.mark.parametrize("flags", [
    ["--durable", "--priority", "--high-every", "3"],
    ["--bulk-arrivals", "--durable", "--arrival", "3"],
], ids=["priority", "bulk"])
def test_serve_main_matches_jax(flags, tmp_path):
    got, want = _run_both(BASE + flags, tmp_path)
    assert got == want and any("served 12 sessions" in line for line in got)


def test_serve_crash_resume_matches_jax(tmp_path):
    """``--crash-at`` then ``--resume --expect-exactly-once``: the same
    crash, the same reconciliation line, exactly once."""
    flags = BASE + ["--durable", "--priority", "--high-every", "3", "--state-dir", "STATE"]
    got, want = _run_both(flags + ["--crash-at", "150"], tmp_path)
    assert got == want and got[0].startswith("CRASHED")
    got, want = _run_both(flags + ["--resume", "--expect-exactly-once"], tmp_path)
    assert got == want and got[-1].startswith("exactly-once OK")


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "deepseek-coder-33b"])
def test_serve_model_tokens_match_jax(arch):
    """The port's launcher serves each session the reference model's greedy
    tokens, for the same sessions and the same (carried-across) params."""
    batch, prompt_len, gen = 2, 6, 4
    jcfg = j_get_reduced(arch)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), get_reduced(arch), "cpu")
    served = {}

    def hook(sids, prompts, last, tokens):
        for i, sid in enumerate(sids):
            served[sid] = tokens[i].tolist()

    args = TV.build_parser().parse_args(
        ["--arch", arch, "--reduced", "--batch", str(batch), "--prompt-len", str(prompt_len),
         "--gen", str(gen), "--sessions", "4", "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        out = TV.serve(args, params=params, hook=hook)
    assert out["completed"] == 4 and out["batches"] == 2 and sorted(served) == [1, 2, 3, 4]
    j_pre = jax.jit(lambda p, b: j_prefill(p, jcfg, b, prompt_len + gen + 8))
    j_dec = jax.jit(lambda p, c, b: j_decode_step(p, jcfg, c, b))
    for sid, toks in served.items():
        prompt = np.random.default_rng(sid).integers(0, jcfg.vocab, prompt_len)
        last, cache = j_pre(jparams, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
        want = [int(jnp.argmax(last[0, -1]))]
        for _ in range(gen - 1):
            lg, cache = j_dec(jparams, cache, {"tokens": jnp.asarray([[want[-1]]], jnp.int32)})
            want.append(int(jnp.argmax(lg[0, -1])))
        assert toks == want, sid


def test_served_model_calls_are_unchanged_without_grad(monkeypatch):
    """The served path calls RMSNorm 2L+1 times per prefill and decode step
    and flash attention L times per prefill, as before the backward existed,
    and never through the autograd Functions or the forward with the rows'
    log-sum-exp."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.models import layers

    def refuse(*a, **k):
        raise AssertionError("the served path went through autograd's Function")

    monkeypatch.setattr(RK._RMSNormFn, "apply", refuse)
    monkeypatch.setattr(FK._FlashFn, "apply", refuse)
    monkeypatch.setattr(FK, "flash_attention_lse", refuse)
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counted(name, op):
        def call(*args, **kw):
            calls[name] += 1
            return op(*args, **kw)
        return call

    monkeypatch.setattr(layers, "rmsnorm_op", counted("rmsnorm", layers.rmsnorm_op))
    monkeypatch.setattr(layers, "attention", counted("flash_attention", layers.attention))
    batch, gen, sessions = 2, 4, 4
    args = TV.build_parser().parse_args(
        ["--arch", "smollm-135m", "--reduced", "--batch", str(batch), "--prompt-len", "6",
         "--gen", str(gen), "--sessions", str(sessions), "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        out = TV.serve(args)
    L, prefills = out["cfg"].n_layers, out["batches"]
    assert prefills == sessions // batch
    assert calls == {"rmsnorm": (prefills + prefills * (gen - 1)) * (2 * L + 1),
                     "flash_attention": prefills * L}
