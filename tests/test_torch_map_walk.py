"""The map's plain walk visits only its live lanes, and gives the bits of the
walk over every lane.

``dfc_map_reduce_ref`` (the one-phase map kernel's plain version) and
``combine_map`` (the vectorized combine, which ``phase_grid_combine_ref``
runs phase by phase) loop over ``map_live_lanes``: the lanes where some
shard holds a map op, in announcement order.  Here each is held bit for bit
against the same function walking every lane (``map_live_lanes``
monkeypatched to return them all) on ``kernels/dfc_reduce/cases.py``'s map
cases (a hot bucket filled to ``R_FULL`` and freed by deletes, a run on one
key, CAS on a stored ``-0.0``, lookups after deletes, foreign op codes) and
on the same cases with dead lanes: a routed batch's empty tail, and empty
lanes between live ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.kernels.dfc_reduce import cases as C  # noqa: E402
from repro_torch.kernels.dfc_reduce import ref as R  # noqa: E402


def _every_lane(monkeypatch):
    every = lambda ops: list(range(ops.shape[-1]))  # noqa: E731
    monkeypatch.setattr(T, "map_live_lanes", every)
    monkeypatch.setattr(R, "map_live_lanes", every)


def _case(k_phases, n, holes):
    """map_hot at (K, N); with ``holes`` the last third of the lanes dead in
    every shard (a routed batch's tail) and every fifth lane dead too."""
    name, kind, leaves, keys, ops, params = C.map_hot(k_phases, n, seed=n)
    if holes:
        ops = ops.copy()
        ops[..., 2 * n // 3:] = T.OP_NONE
        ops[..., 9::5] = T.OP_NONE  # past the lead lanes of shard 0
    return leaves, keys, ops, params


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _leaves(out):
    states, resp, kinds = out
    return [*states.leaves(), resp, kinds]


@pytest.mark.parametrize("k_phases,n,holes", [(1, 64, False), (1, 300, True),
                                              (2, 257, False), (3, 120, True)])
def test_live_lane_walk_is_the_every_lane_walk(k_phases, n, holes, monkeypatch):
    leaves, keys, ops, params = _case(k_phases, n, holes)
    live = T.map_live_lanes(torch.from_numpy(ops[0]))
    assert live == sorted(live) and (len(live) < n) == holes
    one = [torch.from_numpy(np.ascontiguousarray(a)) for a in
           C.map_reduce_args(("map_hot", "map", leaves, keys, ops, params))]
    state = T.state_from_numpy("map", leaves, device="cpu")
    lanes = [torch.from_numpy(a) for a in (ops, params, keys)]
    got_one = R.dfc_map_reduce_ref(*one)
    got_grid = _leaves(R.phase_grid_combine_ref("map", state, *lanes))
    _every_lane(monkeypatch)
    _same(got_one, R.dfc_map_reduce_ref(*one))
    _same(got_grid, _leaves(R.phase_grid_combine_ref("map", state, *lanes)))
    kinds = got_grid[-1]
    assert bool((kinds == T.R_FULL).any()) and bool((kinds == T.R_VALUE).any())


def test_a_phase_without_map_ops_walks_no_lane(monkeypatch):
    """No live lane: the combine answers nothing, writes no slot, keeps the
    count and bumps the epoch, as the walk over every lane does."""
    leaves, keys, ops, params = _case(1, 64, False)
    ops = np.where(ops == C.FOREIGN, ops, T.OP_NONE).astype(np.int32)
    ops[0, 1, :5] = C.FOREIGN
    state = T.state_from_numpy("map", leaves, device="cpu")
    lanes = [torch.from_numpy(a) for a in (ops[0], params[0], keys[0])]
    assert T.map_live_lanes(lanes[0]) == []
    got = T.combine_map(state, lanes[2], lanes[0], lanes[1])
    _every_lane(monkeypatch)
    want = T.combine_map(state, lanes[2], lanes[0], lanes[1])
    _same(_leaves(got), _leaves(want))
    assert not bool(got[2].any()) and torch.equal(got[0].epoch, state.epoch + 2)
