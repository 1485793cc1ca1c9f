"""The port's paper objects against the reference's, in one process.

Twins of ``tests/test_dfc_basic.py``, ``test_dfc_queue.py``,
``test_dfc_deque.py`` and ``test_dfc_property.py``: each runs the same
workload, scheduler seed and crash point through ``repro`` and
``repro_torch`` (``tests/_paper_twins.py``) and requires the histories,
per-tag pwb/pfence counts, phases, eliminated pairs, NVM lines, crash
results and verdicts to be equal, then makes the reference test's own
assertions on the port's result.  The queue's and deque's larger crash
sweeps take every other crash point of the reference's stride-7 sweep
(stride 14, the two seeds offset by 7); their exhaustive sweeps are in
``tests/test_torch_paper_sweeps.py``.
"""

import pytest

from _compat import hypothesis, st
from _paper_twins import (
    PKGS,
    crash_both,
    linearizable_both,
    run_both,
    sweep_both,
    total_steps_both,
)
from repro_torch.core.dfc import (
    ACK, DEQ, EMPTY, ENQ, POP, POPL, POPR, PUSH, PUSHL, PUSHR,
)

SMALL = {
    "stack": [[(PUSH, 11), (POP, None)], [(PUSH, 22), (PUSH, 23)], [(POP, None), (PUSH, 33)]],
    "queue": [[(ENQ, 11), (DEQ, None)], [(ENQ, 22), (ENQ, 23)], [(DEQ, None), (ENQ, 33)]],
    "deque": [[(PUSHL, 11), (POPR, None)], [(PUSHR, 22), (PUSHL, 23)],
              [(POPL, None), (PUSHR, 33)]],
}
LARGER = {
    "queue": [[(ENQ, 100 * t + i) for i in range(2)] + [(DEQ, None)] for t in range(4)],
    "deque": [[(PUSHL if (t + i) % 2 else PUSHR, 100 * t + i) for i in range(2)]
              + [(POPL if t % 2 else POPR, None)] for t in range(4)],
}
INSERTS = {"stack": (PUSH,), "queue": (ENQ,), "deque": (PUSHL, PUSHR)}
REMOVES = {"stack": (POP,), "queue": (DEQ,), "deque": (POPL, POPR)}


def _values(hist):
    return [o["value"] for o in hist.ops]


def _conservation(structure, hist, obj):
    pushed = {o["param"] for o in hist.ops if o["name"] in INSERTS[structure]}
    popped = {o["value"] for o in hist.ops
              if o["name"] in REMOVES[structure] and o["value"] != EMPTY}
    remaining = set(obj.snapshot())
    assert popped | remaining == pushed
    assert popped & remaining == set()


# ------------------------------------------------------ test_dfc_basic twins
def test_single_thread_push_pop():
    ops = [[(PUSH, 10), (PUSH, 20), (POP, None), (POP, None), (POP, None)]]
    stack, hist, _ = run_both("stack", ops)
    assert _values(hist) == [ACK, ACK, 20, 10, EMPTY]
    assert stack.peek_stack() == []


@pytest.mark.parametrize("structure,ops", [
    ("stack", [[(POP, None)], [(POP, None)]]),
    ("queue", [[(DEQ, None)], [(DEQ, None)]]),
    ("deque", [[(POPL, None)], [(POPR, None)]]),
])
def test_remove_empty_returns_empty(structure, ops):
    _, hist, _ = run_both(structure, ops)
    assert all(o["value"] == EMPTY for o in hist.ops)


@pytest.mark.parametrize("seed", range(8))
def test_concurrent_push_pop_linearizable(seed):
    ops = [[(PUSH, 100 * t + i) for i in range(2)] + [(POP, None)] for t in range(4)]
    stack, hist, _ = run_both("stack", ops, seed=seed)
    assert linearizable_both(hist.ops)
    _conservation("stack", hist, stack)


@pytest.mark.parametrize("seed", range(4))
def test_balanced_workload_drains(seed):
    ops = [[(PUSH, 10 * t + i) for i in range(3)] + [(POP, None)] * 3 for t in range(6)]
    stack, hist, _ = run_both("stack", ops, seed=seed)
    assert linearizable_both(hist.ops[:12])
    assert stack.peek_stack() == []


@pytest.mark.parametrize("structure,ins,rem", [
    ("stack", PUSH, POP), ("queue", ENQ, DEQ), ("deque", PUSHL, POPL)])
def test_elimination_reduces_persistence(structure, ins, rem):
    """Paired inserts and removes are eliminated: the structure is untouched
    and combiner-path pwbs stay below 2 per op (the stack's, the queue's
    two-sided and the deque's same-side elimination)."""
    n = 8
    ops = [[(ins, t)] if t % 2 == 0 else [(rem, None)] for t in range(n)]
    obj, hist, mem = run_both(structure, ops, seed=3)
    pushed = {o["param"] for o in hist.ops if o["name"] == ins}
    popped = {o["value"] for o in hist.ops if o["name"] == rem and o["value"] != EMPTY}
    assert set(obj.snapshot()) == pushed - popped
    assert mem.stats.pwb.get("combine", 0) < 2 * n


def test_epoch_parity_and_phase_count():
    stack, _, mem = run_both("stack", [[(PUSH, 1)], [(PUSH, 2)], [(PUSH, 3)]])
    assert mem.read("cEpoch", "v") % 2 == 0
    assert stack.phases >= 1
    assert sorted(stack.peek_stack()) == [1, 2, 3]


@pytest.mark.parametrize("structure,ops", [
    ("stack", [[(PUSH, 1)], [(POP, None)]]), ("queue", [[(ENQ, 1)], [(DEQ, None)]]),
    ("deque", [[(PUSHR, 1)], [(POPL, None)]])])
def test_announce_vs_combine_attribution(structure, ops):
    _, _, mem = run_both(structure, ops)
    assert mem.stats.pwb["announce"] == 2 * 2
    assert mem.stats.pfence["announce"] == 2 * 2
    assert mem.stats.pfence.get("combine", 0) % 2 == 0


# ------------------------------------------------------ test_dfc_queue twins
def test_single_thread_fifo_order():
    ops = [[(ENQ, 10), (ENQ, 20), (ENQ, 30), (DEQ, None), (DEQ, None), (ENQ, 40), (DEQ, None),
            (DEQ, None), (DEQ, None)]]
    q, hist, _ = run_both("queue", ops)
    assert _values(hist) == [ACK, ACK, ACK, 10, 20, ACK, 30, 40, EMPTY]
    assert q.peek_queue() == []


@pytest.mark.parametrize("seed", range(8))
def test_concurrent_enq_deq_linearizable(seed):
    ops = [[(ENQ, 100 * t + i) for i in range(2)] + [(DEQ, None)] for t in range(4)]
    q, hist, _ = run_both("queue", ops, seed=seed)
    assert linearizable_both(hist.ops, semantics="queue")
    _conservation("queue", hist, q)


# ------------------------------------------------------ test_dfc_deque twins
def test_single_thread_both_ends():
    ops = [[(PUSHL, 1), (PUSHR, 2), (PUSHL, 3), (POPR, None), (POPL, None), (POPL, None),
            (POPL, None)]]
    d, hist, _ = run_both("deque", ops)
    assert _values(hist) == [ACK, ACK, ACK, 2, 3, 1, EMPTY]
    assert d.peek_deque() == []


@pytest.mark.parametrize("ops,want", [
    ([(PUSHL, 1), (PUSHL, 2), (POPL, None), (POPL, None)], [ACK, ACK, 2, 1]),
    ([(PUSHR, 1), (PUSHR, 2), (POPR, None), (POPR, None)], [ACK, ACK, 2, 1]),
    ([(PUSHR, 1), (PUSHR, 2), (POPL, None), (POPL, None)], [ACK, ACK, 1, 2]),
    ([(PUSHL, 1), (PUSHL, 2), (POPR, None), (POPR, None)], [ACK, ACK, 1, 2]),
])
def test_deque_stack_and_queue_modes(ops, want):
    """One end only is a stack (LIFO); pushing at one end and popping at the
    other is a FIFO queue."""
    _, hist, _ = run_both("deque", [ops])
    assert _values(hist) == want


@pytest.mark.parametrize("seed", range(8))
def test_concurrent_mixed_ends_linearizable(seed):
    workloads = [
        [(PUSHL, 100 + seed), (POPR, None)],
        [(PUSHR, 200 + seed), (POPL, None)],
        [(PUSHL, 300 + seed), (PUSHR, 400 + seed)],
        [(POPR, None)],
    ]
    d, hist, _ = run_both("deque", workloads, seed=seed)
    assert linearizable_both(hist.ops, semantics="deque")
    _conservation("deque", hist, d)


# ------------------------------------------- queue and deque crash sweeps
@pytest.mark.parametrize("structure", ["queue", "deque"])
def test_random_eviction_crash_sweep(structure):
    failures, _ = sweep_both(SMALL[structure], 1, "RANDOM", 2, structure)
    assert not failures


@pytest.mark.parametrize("structure", ["queue", "deque"])
@pytest.mark.parametrize("seed", range(2))
def test_crash_sweep_larger(structure, seed):
    """Every other point of the reference's stride-7 sweep."""
    failures, _ = sweep_both(LARGER[structure], seed, "RANDOM", 14, structure,
                             start=1 + 7 * seed)
    assert not failures


@pytest.mark.parametrize("structure", ["queue", "deque"])
def test_double_crash_during_recovery(structure):
    steps = total_steps_both(SMALL[structure], seed=2, structure=structure)
    for k in range(5, steps, 11):
        for rk in (3, 29):
            _, ok = crash_both(SMALL[structure], k, 2, "RANDOM", structure,
                               recovery_crash_at=rk)
            assert ok


@pytest.mark.parametrize("structure", ["stack", "queue", "deque"])
def test_epoch_fixed_to_even_after_recovery(structure):
    res, _ = crash_both(SMALL[structure], 40, 0, "MIN", structure)
    assert res.mem.read("cEpoch", "v") % 2 == 0


def test_recovered_queue_is_fifo_consistent():
    workloads = [[(ENQ, 7 * t + i) for i in range(3)] for t in range(3)]
    steps = total_steps_both(workloads, seed=4, structure="queue")
    for k in range(10, steps, 13):
        _, ok = crash_both(workloads, k, 4, "RANDOM", "queue")
        assert ok


# --------------------------------------------------- test_dfc_property twins
def _coded(op_codes):
    out, uid = [], 0
    for codes in op_codes:
        ops = []
        for c in codes:
            uid += 1
            ops.append((PUSH, 1000 + uid) if c else (POP, None))
        out.append(ops)
    return out


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(
    st.lists(st.lists(st.integers(0, 1), min_size=1, max_size=3), min_size=2, max_size=4),
    st.integers(0, 2**16),
)
def test_property_crash_free_linearizable(op_codes, seed):
    w = _coded(op_codes)
    stack, hist, mem = run_both("stack", w, seed=seed)
    assert linearizable_both(hist.ops)
    pushed = {o["param"] for o in hist.ops if o["name"] == PUSH}
    popped = {o["value"] for o in hist.ops if o["name"] == POP and o["value"] != EMPTY}
    assert popped | set(stack.peek_stack()) == pushed
    n_ops = sum(len(x) for x in w)
    assert mem.stats.pwb["announce"] == 2 * n_ops
    assert mem.stats.pfence["announce"] == 2 * n_ops
    assert mem.read("cEpoch", "v") == 2 * stack.phases


@hypothesis.settings(max_examples=12, deadline=None)
@hypothesis.given(
    st.lists(st.lists(st.integers(0, 1), min_size=1, max_size=2), min_size=2, max_size=3),
    st.integers(0, 2**10),
    st.floats(0.05, 0.95),
    st.sampled_from(["MIN", "MAX", "RANDOM"]),
)
def test_property_durable_under_random_crash(op_codes, seed, frac, mode):
    w = _coded(op_codes)
    steps = total_steps_both(w, seed=seed)
    _, ok = crash_both(w, max(1, int(steps * frac)), seed, mode)
    assert ok


def test_property_run_dfc_counts_equal():
    """``run_dfc_counts`` (imported by ``test_dfc_property``) on both packages
    at a small mixed workload, with think time."""
    w = _coded([[1, 0, 1], [0, 1, 0], [1, 1, 0]])
    got = [pkg.baselines.run_dfc_counts(3, w, seed=5, think=(0, 4)) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[1]["pwb_announce"] == 2 * 9
