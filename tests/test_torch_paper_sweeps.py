"""The queue's and deque's exhaustive crash sweeps, both packages in one
process (twins of ``test_exhaustive_crash_sweep_every_step`` of
``tests/test_dfc_queue.py`` and ``tests/test_dfc_deque.py``; the rest of
those files' twins are in ``tests/test_torch_paper_objects.py``).

A crash at every scheduler step of thread 0's in-flight insert and remove,
in MIN and MAX mode: both packages' crash results and verdicts equal at
every point (``tests/_paper_twins.py``), every point durably linearizable,
and detectability firing both ways.
"""

import pytest

from _paper_twins import sweep_both
from repro_torch.core.dfc import DEQ, ENQ, POPL, POPR, PUSHL, PUSHR

SMALL = {
    "queue": [[(ENQ, 11), (DEQ, None)], [(ENQ, 22), (ENQ, 23)], [(DEQ, None), (ENQ, 33)]],
    "deque": [[(PUSHL, 11), (POPR, None)], [(PUSHR, 22), (PUSHL, 23)],
              [(POPL, None), (PUSHR, 33)]],
}


@pytest.mark.parametrize("structure", ["queue", "deque"])
@pytest.mark.parametrize("mode", ["MIN", "MAX"])
def test_exhaustive_crash_sweep_every_step(structure, mode):
    failures, outcomes = sweep_both(SMALL[structure], 0, mode, 1, structure)
    assert not failures, f"non-linearizable effective history at crash points {failures}"
    assert outcomes == {True, False}
