"""The combine kernels' plain versions and the combine steps against JAX.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them bit for bit against these plain versions there).  Here, on the CPU,
the kernel wrappers take their plain versions (the tensors lie on the CPU),
and those are held bit for bit against ``jax.vmap`` of the JAX package's
``ref.py`` and against its Pallas grid kernels in interpret mode, at S=3 and
N in {8, 32, 128}, plus adversarial batches and the ring and map stress cases
of ``kernels/dfc_reduce/cases.py`` (the inputs ``chip_smoke.py`` holds the
card's ring and map kernels to, here at small sizes).  The sharded,
single-object and chained combine steps are held against their JAX
counterparts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_dfc as J  # noqa: E402
from repro.kernels.dfc_reduce import kernel as JK  # noqa: E402
from repro.kernels.dfc_reduce import ops as JO  # noqa: E402
from repro.kernels.dfc_reduce import ref as JR  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402
from repro_torch.kernels.dfc_reduce import cases as TC  # noqa: E402
from repro_torch.kernels.dfc_reduce import kernel as TK  # noqa: E402
from repro_torch.kernels.dfc_reduce import ops as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

S = 3
NOPS = {"stack": 3, "queue": 3, "deque": 5, "map": 5}


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def assert_outs(jouts, touts):
    assert len(jouts) == len(touts)
    for i, (a, b) in enumerate(zip(jouts, touts)):
        assert_same(np.asarray(a), b.numpy(), f"output {i}")


def assert_state_same(jstate, tstate):
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jstate),
                                   T.state_to_numpy(tstate))):
        assert_same(np.asarray(a), b, f"leaf {i}")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ring_inputs(rng, kind, n):
    ops = rng.integers(0, NOPS[kind], (S, n)).astype(np.int32)
    params = (rng.random((S, n)) * 100).round(2).astype(np.float32)
    windows = (rng.random((2, S, n)) * 50).round(1).astype(np.float32)
    sizes = rng.integers(0, n + 3, S).astype(np.int32)
    return ops, params, windows, sizes


def _map_inputs(rng, n, cap=64):
    bslots, n_buckets = T.map_geometry(cap)
    mkeys = np.zeros((S, cap), np.int32)
    mvals = np.zeros((S, cap), np.float32)
    mocc = np.zeros((S, cap), np.int32)
    counts = np.zeros((S,), np.int32)
    for s in range(S):  # a consistent random table per shard
        for key in rng.choice(40, 12, replace=False):
            base = int(T.map_bucket_host([key], n_buckets)[0]) * bslots
            free = [j for j in range(bslots) if not mocc[s, base + j]]
            if free:
                mkeys[s, base + free[0]] = key
                mvals[s, base + free[0]] = float(rng.integers(0, 8))
                mocc[s, base + free[0]] = 1
                counts[s] += 1
    lkeys = rng.integers(0, 48, (S, n)).astype(np.int32)
    ops = rng.integers(0, 5, (S, n)).astype(np.int32)
    params = rng.integers(0, 8, (S, n)).astype(np.float32)
    cas = ops == T.OP_MAP_CAS
    params[cas] = rng.integers(0, 8, int(cas.sum())) * T.CAS_DOM + rng.integers(0, 8, int(cas.sum()))
    return mkeys, mvals, mocc, counts, lkeys, ops, params


def _check_ring(kind, ops, params, windows, sizes, pallas=True):
    if kind == "deque":
        args = (ops, params, windows[0], windows[1], sizes)
        jref, jgrid, tcall = (JR.dfc_deque_reduce_ref, JK.dfc_deque_reduce_grid_call,
                              TK.dfc_deque_reduce_grid_call)
    else:
        args = (ops, params, windows[0], sizes)
        jref, jgrid, tcall = {
            "stack": (JR.dfc_reduce_ref, JK.dfc_reduce_grid_call,
                      TK.dfc_reduce_grid_call),
            "queue": (JR.dfc_queue_reduce_ref, JK.dfc_queue_reduce_grid_call,
                      TK.dfc_queue_reduce_grid_call),
        }[kind]
    touts = tcall(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    assert_outs(jax.vmap(jref)(*jargs), touts)
    if pallas:
        assert_outs(jgrid(*jargs, interpret=True), touts)
    return touts


@pytest.mark.parametrize("n", [8, 32, 128])
@pytest.mark.parametrize("kind", ["stack", "queue", "deque"])
def test_ring_plain_matches_jax_ref_and_pallas(kind, n):
    rng = np.random.default_rng(n + len(kind))
    for _ in range(2):
        _check_ring(kind, *_ring_inputs(rng, kind, n))


@pytest.mark.parametrize("n", [8, 32, 128])
def test_map_plain_matches_jax_ref_and_pallas(n):
    rng = np.random.default_rng(100 + n)
    args = _map_inputs(rng, n)
    touts = TK.dfc_map_reduce_grid_call(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    assert_outs(jax.vmap(JR.dfc_map_reduce_ref)(*jargs), touts)
    pk = JK.dfc_map_reduce_grid_call(*jargs, interpret=True)
    assert_outs(pk[:3] + (pk[3][:, 0],) + pk[4:], touts)


@pytest.mark.parametrize("n", [16, 100, 256])
def test_map_stress_cases_match_jax_ref_and_pallas(n):
    """The map stress case's first phase: every lane of shard 0 on one
    bucket's keys (R_FULL until a delete frees a slot), a stored -0.0 read
    through a lookup and a CAS (+0.0 here: the masked window sum), shard 1's
    lanes over many buckets with foreign codes, shard 2 untouched."""
    args = TC.map_reduce_args(TC.map_hot(1, n))
    touts = TK.dfc_map_reduce_grid_call(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    assert_outs(jax.vmap(JR.dfc_map_reduce_ref)(*jargs), touts)
    pk = JK.dfc_map_reduce_grid_call(*jargs, interpret=True)
    assert_outs(pk[:3] + (pk[3][:, 0],) + pk[4:], touts)
    resp, kinds = touts[4].numpy(), touts[5].numpy()
    assert kinds[0, 0] == T.R_VALUE and resp[0, 0] == 0 and not np.signbit(resp[0, 0])
    assert list(kinds[0, 1:7]) == [T.R_VALUE, T.R_VALUE, T.R_FULL, T.R_VALUE, T.R_ACK,
                                   T.R_VALUE]
    assert (kinds[2] == T.R_NONE).all()


@pytest.mark.parametrize("n", [8, 33, 128])
@pytest.mark.parametrize("kind", ["stack", "queue", "deque"])
@pytest.mark.parametrize("case", ["ring_forward", "ring_edges", "ring_drain"])
def test_ring_stress_cases_match_jax_ref_and_pallas(case, kind, n):
    """The one-phase ring kernels' stress inputs (``cases.ring_reduce_args``):
    ``ring_forward``'s first phase (mostly pushes, -0.0 pushed early and
    late, random ops with foreign codes), ``ring_edges`` (N/2 lanes
    eliminated at an even N; every pop of shard 1 but two past the window,
    the first reading a committed -0.0) and ``ring_drain`` (shard 0's pops
    served by the window, paired and run empty in one row; every lane of
    shard 1 a pop against more than N committed), shard 2 untouched.  Bit
    for bit against ``jax.vmap`` of the JAX ``ref.py``; against its Pallas
    kernel too, whose one-hot sums start at +0.0, so a committed -0.0 read
    through a window comes back +0.0 there (``test_stack_adversarial``): the
    responses are held to it as ``resp + 0.0``, every other output as it
    is."""
    made = {"ring_forward": lambda: TC.ring_forward(kind, 1, n),
            "ring_edges": lambda: TC.ring_edges(kind, n),
            "ring_drain": lambda: TC.ring_drain(kind, n)}[case]()
    args = TC.ring_reduce_args(made)
    windows = np.stack(args[2:-1])
    touts = _check_ring(kind, args[0], args[1], windows, args[-1], pallas=False)
    jargs = [jnp.asarray(a) for a in args]
    jgrid = {"stack": JK.dfc_reduce_grid_call, "queue": JK.dfc_queue_reduce_grid_call,
             "deque": JK.dfc_deque_reduce_grid_call}[kind]
    pk = jgrid(*jargs, interpret=True)
    assert_outs(pk, (touts[0] + 0.0,) + tuple(touts[1:]))
    resp, kinds, counts = touts[0].numpy(), touts[1].numpy(), touts[-1].numpy()
    assert (kinds[2] == T.R_NONE).all()
    if case == "ring_edges":
        n_elim = counts[0, 4] + counts[0, 5] if kind == "deque" else counts[0, 2]
        if n % (4 if kind == "deque" else 2) == 0:
            assert n_elim == n // 2
        assert list(np.bincount(kinds[1], minlength=4)[[T.R_VALUE, T.R_EMPTY]]) == [2, n - 2]
        assert kinds[1, 0] == T.R_VALUE and np.signbit(resp[1, 0])
    if case == "ring_drain":
        # counts: the pops the window served and the pairs, per kind
        if kind == "deque":
            served, paired = counts[0, 1] + counts[0, 3], counts[0, 4] + counts[0, 5]
        else:
            served, paired = counts[0, 1], counts[0, 2]
        assert served > 0 and paired > 0 and (kinds[0] == T.R_EMPTY).any()
        assert (kinds[1] == T.R_VALUE).all()
        if kind != "deque":  # the last lane reads the window's last slot
            assert resp[1, -1] == args[2][1, n - 1 if kind == "queue" else 0]


def _ring_case(kind, rows, n=8, sizes=(0, 0, 0), windows=None):
    ops = np.zeros((S, n), np.int32)
    params = np.zeros((S, n), np.float32)
    for s, (o, p) in enumerate(rows):
        ops[s, : len(o)] = o
        params[s, : len(p)] = p
    w = np.zeros((2, S, n), np.float32) if windows is None else windows
    return ops, params, w, np.asarray(sizes, np.int32)


def test_stack_adversarial():
    win = np.zeros((2, S, 8), np.float32)
    win[:, 2, -2:] = [7.0, -0.0]
    cases = [
        _ring_case("stack", [([], []), ([], []), ([], [])]),  # empty batch
        _ring_case("stack", [([1] * 8, np.arange(1, 9)), ([1, 1], [-0.0, 2.0]),
                             ([1] * 3, [5.0, 6.0, -0.0])]),  # all pushes
        _ring_case("stack", [([2] * 8, []), ([1, 2, 2, 2], [3.0]),  # pops past bottom
                             ([2, 2, 2], [])], sizes=(0, 0, 2), windows=win),
    ]
    _check_ring("stack", *cases[0])
    resp, kinds, seg, counts = _check_ring("stack", *cases[1])
    assert not np.signbit(seg.numpy()[1, 0])  # a pushed -0.0 lands as +0.0
    # a committed -0.0 in the window: the reference's ref.py returns it as
    # -0.0 (an indexed read), its Pallas kernel as +0.0 (a one-hot product
    # sums in +0.0 terms); the port follows ref.py, so Pallas is left out
    resp, kinds, seg, counts = _check_ring("stack", *cases[2], pallas=False)
    assert np.signbit(resp.numpy()[2, 0])
    assert list(kinds.numpy()[0]) == [T.R_EMPTY] * 8
    assert list(kinds.numpy()[2, :3]) == [T.R_VALUE, T.R_VALUE, T.R_EMPTY]


def test_queue_drained_two_sided_elimination():
    # shard 0: drained queue, deqs pair with enqs of the same phase
    # shard 1: one committed value served first, then pairs, then EMPTY
    win = np.zeros((2, S, 8), np.float32)
    win[:, 1, 0] = 9.0
    case = _ring_case("queue", [([2, 2, 1, 1, 2], [0, 0, 4.0, 5.0]),
                                ([2, 2, 1, 2, 2], [0, 0, 6.0]),
                                ([1, 1, 1], [1.0, -0.0, 3.0])],
                      sizes=(0, 1, 0), windows=win)
    resp, kinds, seg, counts = _check_ring("queue", *case)
    assert list(resp.numpy()[0, :2]) == [4.0, 5.0]
    assert list(resp.numpy()[1, :2]) == [9.0, 6.0]
    assert kinds.numpy()[1, 4] == T.R_EMPTY


def test_deque_right_pops_consume_left_pushes():
    win = np.zeros((2, S, 8), np.float32)
    win[0, 1, 0] = win[1, 1, 0] = 4.0
    case = _ring_case("deque", [([1, 1, 4, 4, 4], [1.0, 2.0]),  # pushL x2, popR x3
                                ([3, 2, 2, 4, 1], [8.0, 0, 0, 0, -0.0]),
                                ([1, 2, 3, 4], [5.0, 0, 6.0])],
                      sizes=(0, 1, 0), windows=win)
    resp, kinds, segl, segr, counts = _check_ring("deque", *case)
    assert list(resp.numpy()[0, 2:4]) == [1.0, 2.0]
    assert kinds.numpy()[0, 4] == T.R_EMPTY


def test_map_adversarial():
    """Full bucket (R_FULL), CAS hit and miss, key 0, and a -0.0 param."""
    cap = 16
    bslots, n_buckets = T.map_geometry(cap)
    same_bucket = [k for k in range(400)
                   if T.map_bucket_host([k], n_buckets)[0] == 0][: bslots + 1]
    n = 16
    lkeys = np.zeros((S, n), np.int32)
    ops = np.zeros((S, n), np.int32)
    params = np.zeros((S, n), np.float32)
    lkeys[0, : bslots + 1] = same_bucket
    ops[0, : bslots + 1] = T.OP_MAP_INSERT
    params[0, : bslots + 1] = np.arange(1, bslots + 2)
    # shard 1: key 0 insert, CAS hit, CAS miss, lookup of a stored -0.0
    lkeys[1, :6] = [0, 0, 0, 3, 3, 0]
    ops[1, :6] = [1, 4, 4, 1, 2, 3]
    params[1, :6] = [2.0, T.pack_cas(2, 7), T.pack_cas(2, 9), -0.0, 0, 0]
    lkeys[2, :3] = [5, 5, 5]
    ops[2, :3] = [2, 3, 4]  # misses on an empty table
    args = (np.zeros((S, cap), np.int32), np.zeros((S, cap), np.float32),
            np.zeros((S, cap), np.int32), np.zeros((S,), np.int32),
            lkeys, ops, params)
    touts = TK.dfc_map_reduce_grid_call(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    assert_outs(jax.vmap(JR.dfc_map_reduce_ref)(*jargs), touts)
    kinds = touts[5].numpy()
    assert kinds[0, bslots] == T.R_FULL
    assert list(kinds[1, :6]) == [T.R_ACK, T.R_VALUE, T.R_CAS_FAIL, T.R_ACK,
                                  T.R_VALUE, T.R_VALUE]
    assert list(kinds[2, :3]) == [T.R_EMPTY] * 3
    assert touts[4].numpy()[1, 2] == 7.0  # CAS miss returns the current value


def _random_phase(rng, kind, n):
    ops = rng.integers(0, NOPS[kind], (S, n)).astype(np.int32)
    ops[rng.integers(0, S)] = 0  # one untouched shard per phase
    params = (rng.random((S, n)) * 100).round(2).astype(np.float32)
    keys = rng.integers(-3, 30, (S, n)).astype(np.int32)
    return keys, ops, params


@pytest.mark.parametrize("kind", ["stack", "queue", "deque", "map"])
def test_sharded_steps_match_jax(kind):
    """``dfc_sharded_*`` steps: port kernel (its plain twin on the CPU) and
    ref backends against JAX ``ref``, port ``torch`` against JAX ``jnp``."""
    rng = np.random.default_rng(21)
    cap, n = 64, 16
    j_ref = J.init_sharded(kind, S, cap)
    j_jnp = J.init_sharded(kind, S, cap)
    t_states = {b: T.init_sharded(kind, S, cap, device="cpu") for b in TO.BACKENDS}
    for _ in range(4):
        keys, ops, params = _random_phase(rng, kind, n)
        jargs = (jnp.asarray(ops), jnp.asarray(params))
        j_ref, jr, jk = JO._one_sharded_combine(
            kind, "ref", j_ref, *jargs, keys=jnp.asarray(keys))
        j_jnp, jr2, jk2 = JO._one_sharded_combine(
            kind, "jnp", j_jnp, *jargs, keys=jnp.asarray(keys))
        for backend in TO.BACKENDS:
            t_states[backend], tr, tk = TO._one_sharded_combine(
                kind, backend, t_states[backend], *_t(ops, params),
                keys=torch.from_numpy(keys))
            want = (j_jnp, jr2, jk2) if backend == "torch" else (j_ref, jr, jk)
            assert_state_same(want[0], t_states[backend])
            assert_same(np.asarray(want[1]), tr.numpy())
            assert_same(np.asarray(want[2]), tk.numpy())


@pytest.mark.parametrize("kind", ["stack", "queue", "deque"])
def test_single_object_steps_match_jax(kind):
    """The single-object steps are the grid kernels at S = 1."""
    rng = np.random.default_rng(4)
    jstep = {"stack": JO.dfc_combine_step, "queue": JO.dfc_queue_combine_step,
             "deque": JO.dfc_deque_combine_step}[kind]
    tstep = {"stack": TO.dfc_combine_step, "queue": TO.dfc_queue_combine_step,
             "deque": TO.dfc_deque_combine_step}[kind]
    js, ts = J.STRUCTS[kind].init(32), T.STRUCTS[kind].init(32, device="cpu")
    for _ in range(4):
        ops = rng.integers(0, NOPS[kind], 8).astype(np.int32)
        params = (rng.random(8) * 10).round(1).astype(np.float32)
        js, jr, jk = jstep(js, jnp.asarray(ops), jnp.asarray(params), backend="ref")
        ts, tr, tk = tstep(ts, *_t(ops, params))
        assert_state_same(js, ts)
        assert_same(np.asarray(jr), tr.numpy())
        assert_same(np.asarray(jk), tk.numpy())


@pytest.mark.parametrize("kind", ["queue", "map"])
def test_multi_batch_chain_and_pass_through(kind):
    """Chained batches match JAX's scanned chain; an all-OP_NONE batch
    leaves state, epochs and counters untouched."""
    rng = np.random.default_rng(9)
    cap, n, b = 64, 8, 4
    phases = [_random_phase(rng, kind, n) for _ in range(b)]
    keys = np.stack([p[0] for p in phases])
    ops = np.stack([p[1] for p in phases])
    params = np.stack([p[2] for p in phases])
    ops[2] = 0  # the pass-through batch
    js, jr, jk = JO.dfc_sharded_multi_combine_step(
        J.init_sharded(kind, S, cap), jnp.asarray(ops), jnp.asarray(params),
        kind=kind, backend="ref", keys=jnp.asarray(keys))
    ts, tr, tk = TO.dfc_sharded_multi_combine_step(
        T.init_sharded(kind, S, cap, device="cpu"), *_t(ops, params),
        kind=kind, keys=torch.from_numpy(keys))
    assert_state_same(js, ts)
    assert_same(np.asarray(jr), tr.numpy())
    assert_same(np.asarray(jk), tk.numpy())
    for a, c in zip(T.state_to_numpy(T.map_state(lambda leaf: leaf[1], ts)),
                    T.state_to_numpy(T.map_state(lambda leaf: leaf[2], ts))):
        assert a.tobytes() == c.tobytes()
    assert (tk[2].numpy() == T.R_NONE).all()


def test_hetero_combine_step_matches_jax():
    rng = np.random.default_rng(13)
    kinds = ["deque", "map", "queue", "stack"]
    jg = {k: J.init_sharded(k, S, 32) for k in kinds}
    tg = {k: T.init_sharded(k, S, 32, device="cpu") for k in kinds}
    ph = {k: _random_phase(rng, k, 8) for k in kinds}
    jout = JO.dfc_hetero_combine_step(
        jg, {k: jnp.asarray(p[1]) for k, p in ph.items()},
        {k: jnp.asarray(p[2]) for k, p in ph.items()}, backend="ref",
        group_keys={k: jnp.asarray(p[0]) for k, p in ph.items()})
    tout = TO.dfc_hetero_combine_step(
        tg, {k: torch.from_numpy(p[1]) for k, p in ph.items()},
        {k: torch.from_numpy(p[2]) for k, p in ph.items()},
        group_keys={k: torch.from_numpy(p[0]) for k, p in ph.items()})
    assert sorted(tout) == sorted(jout)
    for k in kinds:
        assert_state_same(jout[k][0], tout[k][0])
        assert_same(np.asarray(jout[k][1]), tout[k][1].numpy())
        assert_same(np.asarray(jout[k][2]), tout[k][2].numpy())


def test_wrappers_count_only_card_launches():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing, so the launch counters stay at zero."""
    TK.reset_launches()
    rng = np.random.default_rng(1)
    _check_ring("stack", *_ring_inputs(rng, "stack", 8), pallas=False)
    assert TK.LAUNCHES == {k: 0 for k in ("stack", "queue", "deque", "map")} | {
        f"phase_grid_{k}": 0 for k in ("stack", "queue", "deque", "map")}
    with pytest.raises(ValueError):
        TO._one_sharded_combine(
            "stack", "pallas", T.init_sharded("stack", 1, 8, device="cpu"),
            torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4)))
