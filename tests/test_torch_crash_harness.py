"""The port's crash harness against the reference's, in one process.

Twins of ``tests/test_crash_recovery.py`` (the stack under all three
eviction adversaries, a second crash during recovery, detectability both
ways): at every crash point both packages' ``run_with_crash`` results --
the history, the recovered responses, the effective history, the
took-effect verdicts, the NVM lines and per-tag counts after recovery --
and their ``check_durable_linearizability`` verdicts must be equal
(``tests/_paper_twins.py``).  The larger sweep takes every third point of
the reference's stride-7 sweep (stride 21, the seeds offset by 7); the
small sweeps and the double-crash sweep keep every point.
"""

import pytest

from _paper_twins import PKGS, crash_both, sweep_both, total_steps_both
from repro_torch.core.dfc import POP, PUSH

SMALL = [
    [(PUSH, 11), (POP, None)],
    [(PUSH, 22), (PUSH, 23)],
    [(POP, None), (PUSH, 33)],
]


@pytest.mark.parametrize("mode", ["MIN", "MAX"])
def test_exhaustive_crash_sweep_small(mode):
    failures, outcomes = sweep_both(SMALL, 0, mode, 1)
    assert not failures, f"non-linearizable effective history at crash points {failures}"
    assert outcomes == {True, False}


def test_random_eviction_crash_sweep():
    failures, _ = sweep_both(SMALL, 1, "RANDOM", 2)
    assert not failures


@pytest.mark.parametrize("seed", range(3))
def test_crash_sweep_larger(seed):
    workloads = [
        [(PUSH, 100 * t + i) for i in range(2)] + [(POP, None)] for t in range(5)
    ]
    failures, _ = sweep_both(workloads, seed, "RANDOM", 21, start=1 + 7 * seed)
    assert not failures


def test_double_crash_during_recovery():
    """The system may crash again while Recover runs (paper §2)."""
    steps = total_steps_both(SMALL, seed=2)
    for k in range(5, steps, 5):
        for rk in (3, 11, 29):
            _, ok = crash_both(SMALL, k, 2, "RANDOM", recovery_crash_at=rk)
            assert ok


def test_detectability_reports_effect():
    outcomes = set()
    for k in range(1, total_steps_both(SMALL, seed=0), 3):
        res, _ = crash_both(SMALL, k, 0, "MIN")
        outcomes.update(res.took_effect.values())
    assert outcomes == {True, False}


def test_recovered_stack_is_consistent_state():
    workloads = [[(PUSH, 7 * t + i) for i in range(3)] for t in range(3)]
    for k in range(10, total_steps_both(workloads, seed=4), 13):
        _, ok = crash_both(workloads, k, 4, "RANDOM")
        assert ok


def test_crash_free_run_is_not_crashed():
    """``crash_at=None`` (and a crash point past the end) runs to completion
    in both packages with the same history."""
    steps = total_steps_both(SMALL, seed=0)
    for crash_at in (None, steps + 5):
        res, ok = crash_both(SMALL, crash_at, 0, "MIN")
        assert not res.crashed and ok and res.took_effect == {}


def test_random_mode_needs_rng():
    """``NVMemory.crash`` in RANDOM mode raises without an rng, in both."""
    for pkg in PKGS:
        mem = pkg.memory.NVMemory()
        mem.alloc_line("x", v=0)
        mem.write("x", "v", 1)
        with pytest.raises(ValueError, match="rng"):
            mem.crash(pkg.memory.CrashMode.RANDOM)
