"""Shared helpers of the port's paper-object twins: run one workload through
the reference's host objects (``repro.core``, ``repro.nvm``) and the port's
(``repro_torch.core``, ``repro_torch.nvm``) in this process and require
everything observable to be equal: histories, per-tag pwb/pfence counts,
phases, eliminated pairs, every NVM line (persisted value, cache, write
history, fenced mark), crash results and every verdict."""

from __future__ import annotations

import types

import repro.core.baselines as R_baselines
import repro.core.dfc as R_dfc
import repro.core.dfc_deque as R_deque
import repro.core.dfc_queue as R_queue
import repro.core.harness as R_harness
import repro.core.linearize as R_linearize
import repro.core.sim as R_sim
import repro.nvm.memory as R_memory
import repro_torch.core.baselines as P_baselines
import repro_torch.core.dfc as P_dfc
import repro_torch.core.dfc_deque as P_deque
import repro_torch.core.dfc_queue as P_queue
import repro_torch.core.harness as P_harness
import repro_torch.core.linearize as P_linearize
import repro_torch.core.sim as P_sim
import repro_torch.nvm.memory as P_memory


def _pkg(dfc, queue, deque, harness, linearize, sim, memory, baselines):
    return types.SimpleNamespace(
        structures={"stack": dfc.DFCStack, "queue": queue.DFCQueue, "deque": deque.DFCDeque},
        harness=harness, linearize=linearize, sim=sim, memory=memory, baselines=baselines)


REF = _pkg(R_dfc, R_queue, R_deque, R_harness, R_linearize, R_sim, R_memory, R_baselines)
PORT = _pkg(P_dfc, P_queue, P_deque, P_harness, P_linearize, P_sim, P_memory, P_baselines)
PKGS = (REF, PORT)


def nvm_lines(mem):
    """Every NVM line as plain data: (persisted, cache, write history, fenced)."""
    return {lid: (line.committed, line.cache, line.history, line.fenced)
            for lid, line in mem._lines.items()}


def structure_view(obj, mem):
    """What a run leaves behind that the two packages must agree on."""
    return dict(phases=obj.phases, eliminated_pairs=obj.eliminated_pairs,
                combined_ops=obj.combined_ops, pwb=dict(mem.stats.pwb),
                pfence=dict(mem.stats.pfence), lines=nvm_lines(mem),
                snapshot=obj.snapshot(), volatile=obj.vol)


def run(pkg, structure, workloads, seed=0):
    """A crash-free run of ``workloads`` (one list a thread) on ``pkg``."""
    mem = pkg.memory.NVMemory()
    obj = pkg.structures[structure](mem, len(workloads))
    sched = pkg.sim.Scheduler(seed=seed)
    hist = pkg.sim.History()
    gens = {t: pkg.sim.workload_gen(obj, sched, hist, t, w) for t, w in enumerate(workloads)}
    sched.run(gens)
    return obj, hist, mem


def run_both(structure, workloads, seed=0):
    """The crash-free run on both packages, required equal; returns the
    port's (structure, history, memory)."""
    (r_obj, r_hist, r_mem), out = (run(pkg, structure, workloads, seed) for pkg in PKGS)
    p_obj, p_hist, p_mem = out
    assert p_hist.ops == r_hist.ops
    assert structure_view(p_obj, p_mem) == structure_view(r_obj, r_mem)
    return out


def linearizable_both(ops, semantics="stack"):
    verdicts = [pkg.linearize.is_linearizable(ops, semantics=semantics) for pkg in PKGS]
    assert verdicts[0] == verdicts[1]
    return verdicts[1]


def crash_view(res):
    return dict(crashed=res.crashed, ops=res.history.ops, recovered=res.recovered,
                effective=res.effective_ops, took_effect=res.took_effect,
                **structure_view(res.stack, res.mem))


def crash_both(workloads, crash_at, seed=0, mode="MIN", structure="stack", **kw):
    """``run_with_crash`` on both packages (``mode`` a ``CrashMode`` name),
    required equal, then ``check_durable_linearizability`` on both (its
    drain leaves the structures equal too); returns (the port's result, its
    verdict)."""
    results = [pkg.harness.run_with_crash(
        workloads, crash_at=crash_at, seed=seed, mode=pkg.memory.CrashMode[mode],
        structure=pkg.structures[structure], **kw) for pkg in PKGS]
    assert crash_view(results[1]) == crash_view(results[0])
    verdicts = [pkg.harness.check_durable_linearizability(res)
                for pkg, res in zip(PKGS, results)]
    assert verdicts[0] == verdicts[1]
    assert structure_view(results[1].stack, results[1].mem) == structure_view(
        results[0].stack, results[0].mem)
    return results[1], verdicts[1]


def total_steps_both(workloads, seed=0, structure="stack"):
    steps = [pkg.harness.total_steps(workloads, seed=seed,
                                     structure=pkg.structures[structure]) for pkg in PKGS]
    assert steps[0] == steps[1]
    return steps[1]


def sweep_both(workloads, seed, mode, stride, structure="stack", start=1):
    """A crash sweep on both packages; the port's failures (crash points not
    durably linearizable) and detectability outcomes."""
    failures, outcomes = [], set()
    for k in range(start, total_steps_both(workloads, seed, structure), stride):
        res, ok = crash_both(workloads, k, seed, mode, structure)
        assert res.crashed
        for tid, effect in res.took_effect.items():
            outcomes.add(effect)
            if effect:
                assert res.recovered[tid] is not P_dfc.BOT
                assert res.recovered[tid] != P_dfc.INIT
        if not ok:
            failures.append(k)
    return failures, outcomes
