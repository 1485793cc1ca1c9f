"""The port's K-phase combine against the JAX package's, on the CPU.

``dfc_multi_phase_step(phase_axis="grid")`` of the port, on the ``kernel``
backend (the K-phase kernel's wrapper, which takes its plain version for
CPU tensors) and on the ``ref`` backend, is held bit for bit against the
JAX package's ``dfc_multi_phase_step(backend="pallas", phase_axis="grid")``
(its Pallas grid over the phase axis, in interpret mode) for all four
kinds: per-phase states, responses, kinds and ``PhaseIntents``.  The
adversarial cases carry a pass-through phase, a shard untouched in every
phase, committed ``-0.0`` values, a deque with a negative ``left`` and a map
bucket filled to ``R_FULL``.  The stress cases of
``kernels/dfc_reduce/cases.py`` (the inputs ``chip_smoke.py`` holds the card's
kernels to, here at small sizes) run at K = 1, 3 and 8.  Grid and scan axes
of the port agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_dfc as J  # noqa: E402
from repro.kernels.dfc_reduce import ops as JO  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.kernels.dfc_reduce import cases as TC  # noqa: E402
from repro_torch.kernels.dfc_reduce import kernel as TK  # noqa: E402
from repro_torch.kernels.dfc_reduce import ops as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

S, CAP = 3, 64
KINDS = ["stack", "queue", "deque", "map"]
NOPS = {"stack": 3, "queue": 3, "deque": 5, "map": 5}
EPOCHS = np.asarray([0, 2, 4], np.int32)  # active root slots 0, 1, 0


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def _jax_state(kind, arrays):
    tree = jax.tree_util.tree_structure(J.init_sharded(kind, S, CAP))
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in arrays])


def _committed_state(rng, kind):
    """Numpy leaves of S committed shards holding a -0.0 where a pop or a
    lookup of the first phase reads it."""
    epoch = EPOCHS.copy()
    active = (epoch // 2) % 2
    if kind == "map":
        bslots, n_buckets = T.map_geometry(CAP)
        keys = np.zeros((S, CAP), np.int32)
        vals = np.zeros((S, CAP), np.float32)
        occ = np.zeros((S, CAP), np.int32)
        count = np.zeros((S, 2), np.int32)
        for s in range(S):
            for key, val in [(7, -0.0)] + [(int(k), float(k % 5)) for k in
                                           rng.choice(np.arange(8, 40), 6, replace=False)]:
                base = int(T.map_bucket_host([key], n_buckets)[0]) * bslots
                free = [j for j in range(bslots) if not occ[s, base + j]][0]
                keys[s, base + free], vals[s, base + free], occ[s, base + free] = key, val, 1
                count[s, active[s]] += 1
        # shard 1: bucket 0 full, so an insert of one more key of it is R_FULL
        for j, key in enumerate(_bucket0_keys()[:bslots]):
            if not occ[1, j]:
                count[1, active[1]] += 1
            keys[1, j], vals[1, j], occ[1, j] = key, 1.0, 1
        return [keys, vals, occ, count, epoch]
    values = (rng.integers(1, 50, (S, CAP))).astype(np.float32)
    if kind == "stack":
        size = np.zeros((S, 2), np.int32)
        size[np.arange(S), active] = [5, 3, 4]
        values[0, 4] = -0.0  # the committed top of shard 0
        values[1, 0] = -0.0  # the bottom of shard 1
        return [values, size, epoch]
    ends = np.zeros((S, 2, 2), np.int32)
    if kind == "queue":
        ends[np.arange(S), active] = [[CAP - 2, CAP + 3], [5, 9], [0, 2]]
        values[0, CAP - 2] = -0.0  # shard 0's head, wrapped ring
        return [values, ends, epoch]
    ends[np.arange(S), active] = [[-3, 4], [-6, -1], [2, 2]]  # negative left
    values[0, CAP - 3] = -0.0  # shard 0's left end
    values[1, CAP - 2] = -0.0  # shard 1's right end (slot right-1 = -2)
    return [values, ends, epoch]


def _bucket0_keys():
    _, n_buckets = T.map_geometry(CAP)
    return [k for k in range(1000, 5000) if T.map_bucket_host([k], n_buckets)[0] == 0]


def _adversarial_phases(rng, kind, k_phases=3, n=16):
    """[K, S, N] phases: phase 1 all OP_NONE (pass-through), shard 2 never
    touched, removals first in phase 0 so they read the committed -0.0."""
    ops = rng.integers(0, NOPS[kind], (k_phases, S, n)).astype(np.int32)
    params = rng.integers(0, 30, (k_phases, S, n)).astype(np.float32)
    params[0, 0, 1] = -0.0  # a pushed -0.0 is routed as +0.0
    keys = np.zeros((k_phases, S, n), np.int32)
    if kind == "map":
        keys = rng.choice([7, 8, 9, 10, 11, 12, 0], (k_phases, S, n)).astype(np.int32)
        ops[0, :, :3] = [T.OP_MAP_LOOKUP, T.OP_MAP_CAS, T.OP_MAP_LOOKUP]
        keys[0, :, :3] = 7  # reads the stored -0.0 (CAS expected 0 matches -0.0)
        params[0, :, 1] = T.pack_cas(0, 3)
        ops[0, 1, 3] = T.OP_MAP_INSERT
        keys[0, 1, 3] = _bucket0_keys()[T.MAP_BUCKET_SLOTS]  # bucket full
        params[0, 1, 3] = -0.0  # an inserted -0.0 is stored as is
        ops[2, 1, :2] = [T.OP_MAP_INSERT, T.OP_MAP_LOOKUP]
        keys[2, 1, :2] = 21
        params[2, 1, 0] = -0.0
        cas = ops == T.OP_MAP_CAS
        params[cas & (keys != 7)] = rng.integers(0, 5, int((cas & (keys != 7)).sum())) * T.CAS_DOM + 2
    else:
        pop = {"stack": T.OP_POP, "queue": T.OP_DEQ, "deque": T.OP_POPL}[kind]
        ops[0, 0, 2:] = T.OP_NONE  # no pushes: shard 0's pops read the ring
        ops[0, :2, :2] = pop
        if kind == "deque":
            ops[0, :2, 2] = T.OP_POPR
            ops[0, 0, 3] = T.OP_PUSHL
    ops[1] = T.OP_NONE
    ops[:, 2] = T.OP_NONE
    return keys, ops, params


def _random_phases(rng, kind, k_phases=4, n=16):
    ops = rng.integers(0, NOPS[kind], (k_phases, S, n)).astype(np.int32)
    params = rng.integers(0, 30, (k_phases, S, n)).astype(np.float32)
    keys = rng.integers(0, 24, (k_phases, S, n)).astype(np.int32)
    if kind == "map":
        cas = ops == T.OP_MAP_CAS
        params[cas] = rng.integers(0, 30, int(cas.sum())) * T.CAS_DOM + 1
    return keys, ops, params


def _run_port(kind, arrays, keys, ops, params, **kw):
    state = T.state_from_numpy(kind, arrays, device="cpu")
    return TO.dfc_multi_phase_step(
        state, torch.from_numpy(ops), torch.from_numpy(params), kind=kind,
        keys=torch.from_numpy(keys), **kw)


def _run_jax_grid(kind, arrays, keys, ops, params):
    return JO.dfc_multi_phase_step(
        _jax_state(kind, arrays), jnp.asarray(ops), jnp.asarray(params), kind=kind,
        backend="pallas", phase_axis="grid", keys=jnp.asarray(keys))


def _assert_step_same(jout, tout):
    jstates, jresp, jkinds, jint = jout
    tstates, tresp, tkinds, tint = tout
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jstates),
                                   T.state_to_numpy(tstates))):
        assert_same(np.asarray(a), b, f"state leaf {i}")
    assert_same(np.asarray(jresp), tresp.numpy(), "resp")
    assert_same(np.asarray(jkinds), tkinds.numpy(), "kinds")
    for f in ("epoch", "touched", "phases_cum", "ops_cum"):
        assert_same(np.asarray(getattr(jint, f)), getattr(tint, f).numpy(), f)


def _assert_port_same(a, b):
    for x, y in zip(a[0].leaves() + list(a[1:3]), b[0].leaves() + list(b[1:3])):
        assert_same(x.numpy(), y.numpy())
    for f in ("epoch", "touched", "phases_cum", "ops_cum"):
        assert_same(getattr(a[3], f).numpy(), getattr(b[3], f).numpy(), f)


@pytest.mark.parametrize("kind", KINDS)
def test_grid_matches_jax_pallas_grid_adversarial(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    arrays = _committed_state(rng, kind)
    keys, ops, params = _adversarial_phases(rng, kind)
    jout = _run_jax_grid(kind, arrays, keys, ops, params)
    for backend in ("kernel", "ref"):
        tout = _run_port(kind, arrays, keys, ops, params, backend=backend,
                         phase_axis="grid")
        _assert_step_same(jout, tout)
    states, resp, kinds, intents = tout
    # the pass-through phase and the untouched shard keep state and epoch
    for leaf in states.leaves():
        assert_same(leaf[1].numpy(), leaf[0].numpy())
    assert not intents.touched[1].any() and not intents.touched[:, 2].any()
    assert (kinds[:, 2] == T.R_NONE).all() and (resp[:, 2] == 0).all()
    if kind == "map":
        # the stored -0.0 reads back as -0.0; the full bucket rejects
        assert np.signbit(resp[0, 0, 0].item()) and kinds[0, 0, 0] == T.R_VALUE
        assert kinds[0, 1, 3] == T.R_FULL
    elif kind == "stack":
        assert np.signbit(resp[0, 0, 0].item()) and kinds[0, 0, 0] == T.R_VALUE


@pytest.mark.parametrize("k_phases, n", [(1, 32), (3, 100), (8, 32)])
@pytest.mark.parametrize("kind", KINDS)
def test_grid_stress_cases_match_jax_pallas_grid(kind, k_phases, n):
    """The stress cases: ring slots pushed in one phase and overwritten by a
    later phase with the ring wrapping, pops of earlier phases' pushes, a
    map bucket hit by every lane of a shard and filled to R_FULL, a stored
    -0.0 read through a lookup and a CAS, keys over many buckets, an
    untouched shard; bit for bit against JAX's Pallas grid."""
    _, _, arrays, keys, ops, params = next(
        c for c in TC.grid_cases(k_phases, n) if c[1] == kind)
    jout = _run_jax_grid(kind, arrays, keys, ops, params)
    for backend in ("kernel", "ref"):
        tout = _run_port(kind, arrays, keys, ops, params, backend=backend,
                         phase_axis="grid")
        _assert_step_same(jout, tout)
    states, resp, kinds, intents = tout
    assert not intents.touched[:, TC.S - 1].any()
    assert (kinds[:, TC.S - 1] == T.R_NONE).all() and (resp[:, TC.S - 1] == 0).all()
    if kind == "map":  # the slot's own value: the stored -0.0 stays -0.0
        assert np.signbit(resp[0, 0, 0].item()) and kinds[0, 0, 0] == T.R_VALUE
        assert kinds[0, 0, 3] == T.R_FULL
    elif k_phases > 1:  # phase 1's pops read slots that phase 0 pushed
        assert (kinds[1, 0] == T.R_VALUE).sum() > n // 4


@pytest.mark.parametrize("kind", KINDS)
def test_grid_matches_jax_and_port_scan_random(kind):
    """From the empty state, four random phases: the grid matches JAX's grid
    and the port's scan axis on the vectorized and on the kernel backends."""
    rng = np.random.default_rng(10 + KINDS.index(kind))
    arrays = T.state_to_numpy(T.init_sharded(kind, S, CAP, device="cpu"))
    keys, ops, params = _random_phases(rng, kind)
    grid = _run_port(kind, arrays, keys, ops, params, phase_axis="grid")
    _assert_step_same(_run_jax_grid(kind, arrays, keys, ops, params), grid)
    for backend in ("torch", "kernel"):
        _assert_port_same(grid, _run_port(kind, arrays, keys, ops, params,
                                          backend=backend, phase_axis="scan"))


def test_grid_scan_agree_on_committed_negative_zero():
    """On committed -0.0 values the grid keeps the vectorized combine's
    reading, as the port's ``torch`` scan does, for every kind."""
    for kind in KINDS:
        rng = np.random.default_rng(30 + KINDS.index(kind))
        arrays = _committed_state(rng, kind)
        keys, ops, params = _adversarial_phases(rng, kind)
        _assert_port_same(
            _run_port(kind, arrays, keys, ops, params, phase_axis="grid"),
            _run_port(kind, arrays, keys, ops, params, backend="torch",
                      phase_axis="scan"))


def test_hetero_multi_phase_step_matches_jax():
    rng = np.random.default_rng(5)
    jg, tg, g_ops, g_params, g_keys = {}, {}, {}, {}, {}
    for kind in KINDS:
        arrays = _committed_state(rng, kind)
        jg[kind] = _jax_state(kind, arrays)
        tg[kind] = T.state_from_numpy(kind, arrays, device="cpu")
        g_keys[kind], g_ops[kind], g_params[kind] = _random_phases(rng, kind, 3, 8)
    jout = JO.dfc_hetero_multi_phase_step(
        jg, {k: jnp.asarray(v) for k, v in g_ops.items()},
        {k: jnp.asarray(v) for k, v in g_params.items()}, backend="pallas",
        phase_axis="grid", group_keys={k: jnp.asarray(v) for k, v in g_keys.items()})
    tout = TO.dfc_hetero_multi_phase_step(
        tg, {k: torch.from_numpy(v) for k, v in g_ops.items()},
        {k: torch.from_numpy(v) for k, v in g_params.items()}, phase_axis="grid",
        group_keys={k: torch.from_numpy(v) for k, v in g_keys.items()}, unroll=3)
    assert sorted(jout) == sorted(tout) == sorted(KINDS)
    for kind in KINDS:
        _assert_step_same(jout[kind], tout[kind])


def test_grid_backend_and_axis_errors_and_no_card_launch():
    """The vectorized backend has no phase grid (as JAX's jnp); an unknown
    axis raises; on CPU tensors the kernel wrapper launches nothing."""
    st = T.init_sharded("stack", 2, 16, device="cpu")
    ops = torch.ones((2, 2, 4), dtype=torch.int32)
    par = torch.ones((2, 2, 4))
    with pytest.raises(ValueError):
        TO.dfc_multi_phase_step(st, ops, par, kind="stack", backend="torch",
                                phase_axis="grid")
    with pytest.raises(ValueError):
        TO.dfc_multi_phase_step(st, ops, par, kind="stack", phase_axis="diagonal")
    TK.reset_launches()
    TK.phase_grid_call("stack", st, ops, par, torch.zeros_like(ops))
    assert set(TK.LAUNCHES.values()) == {0}


def test_ring_phases_match_jax():
    """A whole schedule lands in the announcement ring in one scatter and
    comes back as [K, pad] per-phase rows, in both packages."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 100, (3, 8)).astype(np.int32)
    ops = rng.integers(0, 3, (3, 8)).astype(np.int32)
    params = rng.random((3, 8)).astype(np.float32)
    jr = J.ring_announce(J.init_announce_ring(32), jnp.arange(5), jnp.ones(5, jnp.int32),
                         jnp.ones(5, jnp.float32))
    tr = T.ring_announce(T.init_announce_ring(32, device="cpu"), torch.arange(5),
                         torch.ones(5, dtype=torch.int32), torch.ones(5))
    jr = J.ring_announce_phases(jr, jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(params))
    tr = T.ring_announce_phases(tr, *(torch.from_numpy(a) for a in (keys, ops, params)))
    for a, b in zip(jax.tree_util.tree_leaves(jr), tr.leaves()):
        assert_same(np.asarray(a), b.numpy())
    for a, b in zip(J.ring_drain_phases(jr, 5, 3, 8), T.ring_drain_phases(tr, 5, 3, 8)):
        assert_same(np.asarray(a), b.numpy())
