"""The port's continuous-batching server against the JAX package's, on the CPU.

``ContinuousServer`` runs the serving loop in which every scheduling
decision is a fabric op (k-class arrivals, weighted admission, the slot
pool, per-round progress, retirement).  Here, with the simulated decoder
and the reference's schedule (``K, WEIGHTS, SIDS, BATCH, GEN, QUANTUM``
of ``tests/test_serve_continuous.py``), the port's tier is crashed at a
stride of persistence ops and resumed: at every crash point its served log
and token log equal the reference's, byte for byte, and audit exactly
once.  The reconciliation cases (a lost arrival overlapping the served log;
a session both in flight and SERVED in the map; SERVED in the map without
a served-log line) give the reference's outcome.  A real model crash-exact
resume runs the reduced ``smollm-135m`` in f32 with params carried across
by ``models/convert.py`` (the reference's own test uses qwen2, which the
port does not have): tokens equal the uncrashed run's and the reference
model's.  The launcher's ``--k-classes`` report lines equal
``python -m repro.launch.serve``'s with times and latency values cut.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro.checkpoint import dfc_checkpoint as JC  # noqa: E402
from repro.launch import serve as JV  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TC  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
K, WEIGHTS = 3, [1, 2, 4]
SIDS = list(range(1, 13))
BATCH, GEN, QUANTUM = 4, 6, 2
TIER_KW = dict(capacity=512, lanes=16, k_classes=K, class_weights=WEIGHTS)
PKGS = {"jax": (JV, JC, {}), "torch": (TV, TC, {"device": "cpu"})}
OBS = {"jax": JO, "torch": TO}


def _fs(pkg, state_dir, crash_at=None):
    ck = PKGS[pkg][1]
    return ck.SimFS(state_dir / "tier", ck.FaultInjector(crash_at=crash_at))


def _drive(pkg, state_dir, crash_at=None, resume=False, decode=None, sids=SIDS,
           batch=BATCH, gen=GEN, quantum=QUANTUM, tier_kw=TIER_KW, obs=None):
    """One launcher pass (fresh or resumed) of ``pkg``'s server; raises
    ``CrashNow`` at the injected op.  Returns (run result, fs)."""
    v, _, dev = PKGS[pkg]
    fs = _fs(pkg, state_dir, crash_at)
    if resume:
        tier, info = v.RequestQueueTier.recover(fs, obs=obs, **tier_kw, **dev)
    else:
        tier = v.RequestQueueTier(slots=batch, durable=True, fs=fs, obs=obs, **tier_kw, **dev)
        info = None
    entries = v._read_token_entries(state_dir)
    k = tier_kw["k_classes"]
    srv = v.ContinuousServer(
        tier, sids=sids, batch=batch, gen=gen, quantum=quantum, arrival=batch,
        class_of=lambda s: s % k, state_dir=state_dir, decode=decode, resume_info=info,
        served_before=v._read_served(state_dir),
        token_log={s: v._committed_tokens(e) for s, e in entries.items()},
    )
    return srv.run(), fs


def _logs(state_dir):
    return tuple((state_dir / name).read_text() if (state_dir / name).exists() else ""
                 for name in ("served.log", "tokens.log"))


def _token_values(state_dir):
    return {s: [t for _, t in sorted(e)]
            for s, e in TV._read_token_entries(state_dir).items()}


def _crash_then_resume(pkg, sd, k, traced=False):
    def observer():
        return OBS[pkg].FabricObserver(root=sd / "tier") if traced else None

    try:
        _drive(pkg, sd, crash_at=k, obs=observer())
        crashed = False
    except PKGS[pkg][1].CrashNow:
        crashed = True
    res, _ = _drive(pkg, sd, resume=True, obs=observer())
    return crashed, res


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_continuous_crash_sweep_matches_jax(traced, tmp_path):
    """Crash both packages' servers at every tenth of the schedule's
    persistence ops (every fifth, offset by one, when traced) and resume: the same
    served and token logs, every session and token index exactly once,
    token values the uncrashed run's; traced, the same timeline across the
    crash (sidecar ``seq`` continued by recovery) without timings."""
    dry = tmp_path / "dry"
    res, dry_fs = _drive("torch", dry)
    assert res["completed"] == len(SIDS)
    TV.verify_exactly_once(SIDS, GEN, TV._read_served(dry), TV._read_token_entries(dry))
    reference = _token_values(dry)
    assert reference == {s: [TV.ContinuousServer.sim_token(s, i) for i in range(GEN)]
                         for s in SIDS}
    jdry = tmp_path / "jdry"
    _, jdry_fs = _drive("jax", jdry)
    assert _logs(dry) == _logs(jdry)
    total = dry_fs.injector.count
    assert total == jdry_fs.injector.count and total > 100, total
    for k in range(1 + int(traced), total + 1, max(1, total // (5 if traced else 10))):
        out = {}
        for pkg in PKGS:
            sd = tmp_path / f"{pkg}{k}"
            crashed, res2 = _crash_then_resume(pkg, sd, k, traced)
            assert res2["completed"] == len(SIDS), (pkg, k, crashed, res2)
            out[pkg] = (crashed, res2, _logs(sd))
            if traced:
                events = TO.read_trace(sd / "tier" / "obs" / "trace.jsonl")
                out[pkg] += ([{f: v for f, v in e.items() if f not in ("ts_us", "dur_us")}
                              for e in events],)
        assert out["torch"] == out["jax"], k
        sd = tmp_path / f"torch{k}"
        TV.verify_exactly_once(SIDS, GEN, TV._read_served(sd), TV._read_token_entries(sd))
        assert _token_values(sd) == reference, k
        if traced:
            seqs = [e["seq"] for e in out["torch"][3]]
            assert seqs == list(range(len(seqs))), k


def test_continuous_run_matches_jax_and_respects_starvation_bound(tmp_path):
    """An uncrashed run: the same admission order, rounds and counts as
    the reference's, and class 0 never passed over for more than
    ``starvation_bound()`` admissions while it had a session queued."""
    runs, tiers = {}, {}
    for pkg in PKGS:
        v, _, dev = PKGS[pkg]
        fs = _fs(pkg, tmp_path / pkg)
        tier = tiers[pkg] = v.RequestQueueTier(slots=BATCH, durable=True, fs=fs, **TIER_KW,
                                               **dev)
        srv = v.ContinuousServer(tier, sids=SIDS, batch=BATCH, gen=GEN, quantum=QUANTUM,
                                 state_dir=tmp_path / pkg)
        res = srv.run()
        runs[pkg] = (res, tier.admit_log, dict(tier.stats), tier.persistence_stats(),
                     tier.session_progress_table())
    assert runs["torch"] == runs["jax"]
    res, admit_log = runs["torch"][:2]
    assert res["completed"] == len(SIDS) and res["decoded_tokens"] == len(SIDS) * GEN
    tier = tiers["torch"]
    assert tier.starvation_bound() == sum(WEIGHTS) - WEIGHTS[0]
    assert 0 < tier.starvation_gap() <= tier.starvation_bound(), admit_log



def test_starvation_gap_counts_only_while_class_0_is_queued():
    """``starvation_gap`` counts other-class admissions from class 0's
    accepted arrival to its admission, and none while class 0 is empty."""
    tier = TV.RequestQueueTier(slots=4, k_classes=3, device="cpu")
    # class 0 arrives before admission 0 and again before admission 4
    tier.arrival_log = [(0, 3, 0), (0, 1, 1), (4, 6, 0)]
    tier.admit_log = [(1, 1), (2, 2), (3, 0), (4, 1), (5, 2), (7, 1), (6, 0), (8, 1)]
    assert tier.starvation_gap() == 2
    tier.arrival_log = [(0, 1, 1), (3, 3, 0)]
    tier.admit_log = [(1, 1), (2, 2), (4, 1), (5, 2), (3, 0)]
    assert tier.starvation_gap() == 1
    with pytest.raises(ValueError, match="k_classes"):
        TV.RequestQueueTier(slots=4, device="cpu").starvation_gap()


# ---------------------------------------------- reconciliation edge cases
def test_lost_arrival_overlapping_served_log_not_double_admitted(tmp_path):
    """A served session whose duplicate re-enqueue was announced but not
    applied shows up in ``lost_arrivals``; reconciled against the served
    log it is never admitted again, at every crash point of the duplicate
    arrival, in both packages."""

    def drive(pkg, fs, served):
        v, _, dev = PKGS[pkg]
        tier = v.RequestQueueTier(slots=2, durable=True, fs=fs, **TIER_KW, **dev)
        tier.submit([7], classes=[1])
        admitted = tier.admit(1)
        assert [s for s, _ in admitted] == [7]
        served.append(7)
        tier.mark_served(7)
        tier.submit([], release_slots=[slot for _, slot in admitted])
        before = fs.injector.count
        tier.submit([7], classes=[1])  # duplicate arrival announced
        return before

    dry = _fs("torch", tmp_path / "dry")
    before = drive("torch", dry, [])
    total = dry.injector.count
    hit = {}
    for k in range(before + 1, total + 1):
        outcome = {}
        for pkg in PKGS:
            v, ck, dev = PKGS[pkg]
            fs, served = _fs(pkg, tmp_path / f"{pkg}{k}", crash_at=k), []
            try:
                drive(pkg, fs, served)
            except ck.CrashNow:
                pass
            tier2, info = v.RequestQueueTier.recover(fs.crash(), **TIER_KW, **dev)
            hit[pkg] = hit.get(pkg, False) or 7 in info["lost_arrivals"]
            assert [s for s in info["lost_arrivals"] if s not in served] == []
            if 7 not in info["queued"]:
                for _ in range(4):
                    admitted = tier2.admit(2)
                    served += [s for s, _ in admitted if s not in served]
                    tier2.submit([], release_slots=[slot for _, slot in admitted])
                assert served == [7], (pkg, k)
            outcome[pkg] = ({x: y for x, y in info.items() if x != "report"}, served)
        assert outcome["torch"] == outcome["jax"], k
    assert hit == {"jax": True, "torch": True}, "the sweep never produced the overlap"


def _served_by_hand(pkg, fs):
    """Admit session 7 by raw phases (pool pop, class-2 dequeue) and mark
    it served: its map entry durably reads SERVED, its dequeue applied."""
    v, _, dev = PKGS[pkg]
    tier = v.RequestQueueTier(slots=2, durable=True, fs=fs, **TIER_KW, **dev)
    tier.submit([7], classes=[2])
    resp, _ = tier._phase([tier._key_for(tier.pool_shard)], [v.OP_POP], [0.0])
    slot = int(resp[0])
    resp, _ = tier._phase([tier._key_for(2)], [v.OP_DEQ], [0.0])
    assert int(resp[0]) == 7
    tier._session_slot[7] = slot
    tier.mark_served(7)


def test_in_flight_and_map_served_not_double_served(tmp_path):
    """A session reported both in ``in_flight`` and SERVED in the session
    map (the overlap injected into the recovery record, as the reference's
    test does) is served once: the served log wins, no token is decoded."""
    out = {}
    for pkg in PKGS:
        v, _, dev = PKGS[pkg]
        fs = _fs(pkg, tmp_path / pkg)
        _served_by_hand(pkg, fs)
        tier2, info = v.RequestQueueTier.recover(fs, **TIER_KW, **dev)
        assert info["sessions"][7]["stage"] == v.SESSION_SERVED
        srv = v.ContinuousServer(
            tier2, sids=[7], batch=2, gen=GEN, quantum=QUANTUM,
            resume_info=dict(info, in_flight=[7]), served_before=[7],
            token_log={7: [v.ContinuousServer.sim_token(7, i) for i in range(GEN)]},
        )
        assert srv.active == {} and srv.pending == []
        out[pkg] = srv.run()
    assert out["torch"] == out["jax"]
    assert out["torch"]["completed"] == 1 and out["torch"]["decoded_tokens"] == 0
    assert out["torch"]["served"] == [7]


def test_map_served_without_served_log_retires_without_redecoding(tmp_path):
    """SERVED in the map, all tokens logged, but no served-log line (the
    crash fell between them): the session resumes, retires and is logged
    with no token decoded again."""
    out = {}
    for pkg in PKGS:
        v, _, dev = PKGS[pkg]
        sd = tmp_path / pkg
        fs = _fs(pkg, sd)
        tier = v.RequestQueueTier(slots=2, durable=True, fs=fs, **TIER_KW, **dev)
        tier.submit([7], classes=[2])
        assert [s for s, _ in tier.admit(1)] == [7]
        v._log_tokens(sd, 7, 0, [v.ContinuousServer.sim_token(7, i) for i in range(GEN)])
        tier.record_progress({7: GEN})
        tier.mark_served(7)
        tier2, info = v.RequestQueueTier.recover(fs, **TIER_KW, **dev)
        assert info["sessions"][7]["stage"] == v.SESSION_SERVED
        assert info["progress"] == {7: GEN}
        entries = v._read_token_entries(sd)
        srv = v.ContinuousServer(
            tier2, sids=[7], batch=2, gen=GEN, quantum=QUANTUM, state_dir=sd,
            resume_info=info, served_before=v._read_served(sd),
            token_log={s: v._committed_tokens(e) for s, e in entries.items()},
        )
        res = srv.run()
        assert res["completed"] == 1 and res["decoded_tokens"] == 0
        v.verify_exactly_once([7], GEN, v._read_served(sd), v._read_token_entries(sd))
        out[pkg] = (res, _logs(sd))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("case", [
    [(0, 5), (1, 6), (0, 7), (2, 8)],
    [(1, 6), (0, 5), (2, 8), (3, 9)],
    [(0, 5), (2, 8)],
    [],
])
def test_committed_tokens_matches_jax(case):
    """The contiguous committed prefix: first write of an index wins."""
    assert TV._committed_tokens(case) == JV._committed_tokens(case)


# ------------------------------------------------------- real model resume
def test_real_model_crash_exact_resume_matches_jax(tmp_path):
    """Crash the tier mid-decode while the reduced smollm-135m (f32) serves
    through it, resume from one recovery walk: the token log equals the
    uncrashed run's, value for value (resumed sessions re-prefill prompt +
    committed history), and the uncrashed tokens equal the reference
    model's on the same carried-across params."""
    from repro.configs import get_reduced as j_get_reduced
    from repro.launch.steps import make_prefill_step as j_prefill
    from repro.launch.steps import make_quantum_step as j_quantum
    from repro.launch.steps import make_serve_step as j_serve
    from repro.models.model import init_params as j_init_params
    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import (
        make_prefill_step,
        make_quantum_step,
        make_serve_step,
    )
    from repro_torch.models.convert import params_from_numpy

    arch = "smollm-135m"
    prompt_len, gen, quantum, batch, sids = 8, 4, 2, 2, [1, 2, 3]
    kw = dict(capacity=512, lanes=16, k_classes=2)
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), cfg, "cpu")
    max_len = prompt_len + gen + 8
    decoders = {
        "jax": lambda: JV.make_model_decode(
            jcfg, jparams, jax.jit(j_prefill(jcfg, max_len=max_len)), jax.jit(j_serve(jcfg)),
            jax.jit(j_quantum(jcfg, quantum=quantum)), prompt_len, quantum),
        "torch": lambda: TV.make_model_decode(
            cfg, params, make_prefill_step(cfg, max_len=max_len), make_serve_step(cfg),
            make_quantum_step(cfg, quantum=quantum), prompt_len, quantum, device="cpu"),
    }

    def drive(pkg, sd, **run_kw):
        return _drive(pkg, sd, decode=decoders[pkg](), sids=sids, batch=batch, gen=gen,
                      quantum=quantum, tier_kw=kw, **run_kw)

    refs = {}
    for pkg in PKGS:
        res, fs = drive(pkg, tmp_path / f"{pkg}_ref")
        assert res["completed"] == len(sids)
        refs[pkg] = (_token_values(tmp_path / f"{pkg}_ref"), fs.injector.count)
    assert refs["torch"] == refs["jax"]
    reference, total = refs["torch"]
    for frac in (0.4, 0.7):
        sd = tmp_path / f"crash{frac}"
        with pytest.raises(TC.CrashNow):
            drive("torch", sd, crash_at=max(1, int(total * frac)))
        res, _ = drive("torch", sd, resume=True)
        assert res["completed"] == len(sids)
        TV.verify_exactly_once(sids, gen, TV._read_served(sd), TV._read_token_entries(sd))
        assert _token_values(sd) == reference, frac


# ---------------------------------------------------------------- launcher
def _summary(text):
    """Report lines with wall-clock times, latency values and temp paths
    cut; ``n=`` counts and the trace line's counts kept."""
    out = []
    for line in text.splitlines():
        line = re.sub(r" in \d+ ms.*", "", line)
        line = re.sub(r"p50=\S+ p99=\S+ mean=\S+ ", "", line)
        line = re.sub(r"durable under \S+; resume with --resume --state-dir \S+",
                      "durable under DIR", line)
        line = re.sub(r"^trace: \S+ \(\+(\d+) metrics, (\d+) chrome events under \S+\)",
                      r"trace: \1 metrics, \2 events", line)
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


BASE = ["--arch", "smollm-135m", "--reduced", "--tier-only", "--sessions", "12",
        "--k-classes", "3", "--durable"]


@pytest.mark.parametrize("flags", [
    [],
    ["--trace", "--class-weights", "1,3,5", "--quantum", "3"],
], ids=["plain", "traced"])
def test_serve_continuous_main_matches_jax(flags, tmp_path):
    got, want = _run_both(BASE + flags, tmp_path)
    assert got == want
    assert got[0].startswith("smollm-135m: continuous batching served 12/12 sessions")
    if "--trace" in flags:
        assert [line.split(":")[0] for line in got[3:]] == ["admission_ms", "e2e_ms",
                                                            "service_ms"]


def test_serve_continuous_crash_resume_matches_jax(tmp_path):
    """``--crash-at`` then ``--resume --expect-exactly-once``, traced: the
    same crash, the same reconciliation line, exactly once."""
    flags = BASE + ["--trace", "--state-dir", "STATE"]
    got, want = _run_both(flags + ["--crash-at", "333"], tmp_path)
    assert got == want and got[0].startswith("CRASHED")
    got, want = _run_both(flags + ["--resume", "--expect-exactly-once"], tmp_path)
    assert got == want and got[0].startswith("resume:")
    assert got[-1] == "exactly-once: OK (sessions + token indices)"


def test_serve_batch_trace_report_matches_jax(tmp_path):
    """The batch path's ``--trace`` report: latency lines and the trace
    line's metric and event counts as the reference prints them."""
    flags = ["--arch", "smollm-135m", "--reduced", "--tier-only", "--sessions", "12",
             "--durable", "--priority", "--high-every", "3", "--trace", "--state-dir", "STATE"]
    got, want = _run_both(flags, tmp_path)
    assert got == want
    assert any(line.startswith("trace: ") for line in got)
    assert (tmp_path / "torch" / "tier" / "obs" / "metrics.jsonl").is_file()
    assert (tmp_path / "torch" / "tier" / "obs" / "trace_chrome.json").is_file()
