"""The port's PTM baselines and ``run_dfc_counts`` against the reference's.

Twins of ``tests/test_baselines.py`` (each baseline's ``BaselineStats`` and
every ``run_dfc_counts`` dict equal between the packages, then the
reference test's claim on the port's numbers), plus the figure 3b-c points
at 1, 8 and 40 threads for each structure and mix, at the benchmark's
settings (``benchmarks/bench_persistence.py``: 800 ops, seed 7, think
(0, 30)).
"""

import dataclasses

import pytest

from _paper_twins import PKGS, PORT
from repro_torch.core.dfc import POP, PUSH

BASELINE_NAMES = ("PMDKStack", "RomulusStack", "OneFileStack", "PMDKQueue", "RomulusQueue",
                  "OneFileQueue")
# the benchmark's pairing: the deque is measured against the queue baselines
PAIRS = {"stack": ("PMDKStack", "RomulusStack", "OneFileStack"),
         "queue": ("PMDKQueue", "RomulusQueue", "OneFileQueue"),
         "deque": ("PMDKQueue", "RomulusQueue", "OneFileQueue")}


def _stats(name, n, kind="push-pop", total=200, structure="stack"):
    """(reference stats, port stats) of one baseline, required equal."""
    got = [getattr(pkg.baselines, name)(n).run(
        pkg.baselines.make_workloads(kind, n, total, structure=structure)) for pkg in PKGS]
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(got[1])
    return got[1]


def _dfc(n, workloads, **kw):
    got = [pkg.baselines.run_dfc_counts(n, workloads, **kw) for pkg in PKGS]
    assert got[0] == got[1]
    return got[1]


@pytest.mark.parametrize("structure", ["stack", "queue", "deque"])
@pytest.mark.parametrize("kind", ["push-pop", "rand-op"])
def test_make_workloads_equal(structure, kind):
    for n in (1, 7, 40):
        w = [pkg.baselines.make_workloads(kind, n, 800, seed=3, structure=structure)
             for pkg in PKGS]
        assert w[0] == w[1]


@pytest.mark.parametrize("name", BASELINE_NAMES)
@pytest.mark.parametrize("kind", ["push-pop", "rand-op"])
def test_baseline_stats_equal(name, kind):
    for n in (1, 16, 40):
        st = _stats(name, n, kind)
        assert st.ops == max(2, 200 // n) * n


def test_pmdk_flat_in_threads():
    a = _stats("PMDKStack", 1).pwb_per_op()
    b = _stats("PMDKStack", 16).pwb_per_op()
    assert abs(a - b) < 0.2


def test_romulus_amortizes_with_combining():
    assert _stats("RomulusStack", 32).pwb_per_op() < _stats("RomulusStack", 1).pwb_per_op()


def test_onefile_grows_with_contention():
    assert _stats("OneFileStack", 32).pwb_per_op() > 2 * _stats("OneFileStack", 1).pwb_per_op()


def test_paper_ordering_at_high_concurrency():
    n, total = 40, 400
    dfc = _dfc(n, PORT.baselines.make_workloads("push-pop", n, total))
    combiner = dfc["pwb_combine"] / dfc["ops"]
    dfc_total = (dfc["pwb_combine"] + dfc["pwb_announce"]) / dfc["ops"]
    rom = _stats("RomulusStack", n, total=total).pwb_per_op()
    one = _stats("OneFileStack", n, total=total).pwb_per_op()
    assert combiner < rom < one
    assert dfc_total < one


def test_counts_similar_across_workloads():
    n, total = 16, 1600
    mk = PORT.baselines.make_workloads
    pp = _dfc(n, mk("push-pop", n, total), seed=1, think=(0, 30))
    ro = _dfc(n, mk("rand-op", n, total), seed=1, think=(0, 30))
    pp_rate = (pp["pwb_combine"] + pp["pwb_announce"]) / pp["ops"]
    ro_rate = (ro["pwb_combine"] + ro["pwb_announce"]) / ro["ops"]
    assert abs(pp_rate - ro_rate) / pp_rate < 0.10


def test_elimination_is_batch_composition_property():
    n = 8
    w_bal = [[(PUSH, 100 + t)] if t < n // 2 else [(POP, None)] for t in range(n)]
    w_push = [[(PUSH, 200 + t)] for t in range(n)]
    assert _dfc(n, w_push, seed=2)["pwb_combine"] > _dfc(n, w_bal, seed=2)["pwb_combine"]


@pytest.mark.parametrize("structure", ["stack", "queue", "deque"])
@pytest.mark.parametrize("kind", ["push-pop", "rand-op"])
@pytest.mark.parametrize("n", [1, 8, 40])
def test_fig3bc_points_equal(structure, kind, n):
    """One point of figure 3b-c: DFC's counts (through each package's own
    DFC structure) and the three baselines' equal between the packages;
    DFC-TOTAL above DFC-combiner by exactly the announce path's 2 pwb and 2
    pfence per op."""
    rows = []
    for pkg in PKGS:
        mk = pkg.baselines.make_workloads
        dfc = pkg.baselines.run_dfc_counts(n, mk(kind, n, 800, structure=structure), seed=7,
                                           think=(0, 30), structure=pkg.structures[structure])
        base = [dataclasses.asdict(getattr(pkg.baselines, name)(n).run(
            mk(kind, n, 800, structure=structure))) for name in PAIRS[structure]]
        rows.append((dfc, base))
    assert rows[0] == rows[1]
    dfc = rows[1][0]
    assert dfc["pwb_announce"] == dfc["pfence_announce"] == 2 * dfc["ops"]
