"""The port's core structures against the JAX reference, bit for bit.

Same numpy-seeded inputs go through ``repro.core.jax_dfc`` and
``repro_torch.core.torch_dfc`` on the CPU; responses, kinds and every state
leaf must have the same dtype and the same bytes (the fabric only moves f32
payloads, so exact equality is the bar).  The pure-Python
``sequential_reference*`` oracles pin the contents as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_dfc as J  # noqa: E402
from repro_torch.core import torch_dfc as T  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

KINDS = [("stack", 3), ("queue", 3), ("deque", 5), ("map", 5)]


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def assert_state_same(jstate, tstate):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    tl = T.state_to_numpy(tstate)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert_same(a, b, f"leaf {i}")


def _batch(rng, kind, nop, n, keyspace=24):
    ops = rng.integers(0, nop, n).astype(np.int32)
    params = (rng.random(n) * 100).round(1).astype(np.float32)
    keys = rng.integers(-4, keyspace, n).astype(np.int32)
    if kind == "map":  # CAS params packed from small operands
        cas = ops == J.OP_MAP_CAS
        params[cas] = [J.pack_cas(rng.integers(0, 4), rng.integers(0, 100))
                       for _ in range(int(cas.sum()))]
    return keys, ops, params


def _contents(kind, tstate):
    one = T.state_to_numpy(tstate)
    active = (int(one[-1]) // 2) % 2
    if kind == "stack":
        return [float(v) for v in one[0][: int(one[1][active])]]
    if kind == "map":
        keys, vals, occ = one[0], one[1], one[2]
        return {int(keys[i]): float(vals[i]) for i in range(len(occ)) if occ[i]}
    cap = one[0].shape[0]
    lo, hi = one[1][active]
    return [float(one[0][i % cap]) for i in range(int(lo), int(hi))]


@pytest.mark.parametrize("kind,nop", KINDS)
def test_combine_matches_jax_and_oracle(kind, nop):
    """Random phases (OP_NONE lanes included) through the JAX vectorized
    combine and the port's: identical bytes, and the oracle's contents."""
    rng = np.random.default_rng(7)
    cap, n = 64, 16
    jstate = J.STRUCTS[kind].init(cap)
    tstate = T.STRUCTS[kind].init(cap, device="cpu")
    oracle = {} if kind == "map" else []
    for phase in range(8):
        keys, ops, params = _batch(rng, kind, nop, n)
        if phase == 3:
            params[0] = -0.0  # a pushed -0.0 must come back with the same bits
        if kind == "map":
            jstate, jr, jk = J.combine_map(
                jstate, jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(params))
            tstate, tr, tk = T.combine_map(
                tstate, torch.from_numpy(keys), torch.from_numpy(ops),
                torch.from_numpy(params))
            oracle, er, ek = T.sequential_reference_map(
                oracle, keys.tolist(), ops.tolist(), params.tolist(), capacity=cap)
        else:
            jstate, jr, jk = J.STRUCTS[kind].combine(
                jstate, jnp.asarray(ops), jnp.asarray(params))
            tstate, tr, tk = T.STRUCTS[kind].combine(
                tstate, torch.from_numpy(ops), torch.from_numpy(params))
            oracle, er, ek = T.STRUCTS[kind].reference(
                oracle, ops.tolist(), params.tolist())
        assert_same(jr, tr.numpy(), "resp")
        assert_same(jk, tk.numpy(), "kinds")
        assert_state_same(jstate, tstate)
        assert list(tk.numpy()) == ek
        np.testing.assert_array_equal(tr.numpy(), np.asarray(er, np.float32))
        assert _contents(kind, tstate) == oracle


@pytest.mark.parametrize("kind,nop", KINDS)
def test_stacked_combine_matches_per_shard_jax(kind, nop):
    """A shard-stacked combine over S objects equals S single-object JAX
    combines, shard by shard (the batch axis written out, no vmap)."""
    rng = np.random.default_rng(11)
    s, cap, n = 3, 32, 8
    jstates = [J.STRUCTS[kind].init(cap) for _ in range(s)]
    tstate = T.init_sharded(kind, s, cap, device="cpu")
    for _ in range(3):
        batches = [_batch(rng, kind, nop, n) for _ in range(s)]
        keys = np.stack([b[0] for b in batches])
        ops = np.stack([b[1] for b in batches])
        params = np.stack([b[2] for b in batches])
        args = (torch.from_numpy(ops), torch.from_numpy(params))
        if kind == "map":
            args = (torch.from_numpy(keys),) + args
        tstate, tr, tk = T.STRUCTS[kind].combine(tstate, *args)
        for i in range(s):
            jargs = (jnp.asarray(ops[i]), jnp.asarray(params[i]))
            if kind == "map":
                jargs = (jnp.asarray(keys[i]),) + jargs
            jstates[i], jr, jk = J.STRUCTS[kind].combine(jstates[i], *jargs)
            assert_same(jr, tr[i].numpy())
            assert_same(jk, tk[i].numpy())
            assert_state_same(jstates[i], T.shard_slice(tstate, i))


def test_deque_negative_left_wraps():
    """Left pushes from an empty deque drive ``left`` negative: slots wrap
    by floor-mod, as the reference's ``%`` does."""
    ops = np.array([J.OP_PUSHL] * 5 + [J.OP_POPR] * 2, np.int32)
    params = np.arange(1, 8, dtype=np.float32)
    js, jr, jk = J.combine_deque(J.init_deque(8), jnp.asarray(ops), jnp.asarray(params))
    ts, tr, tk = T.combine_deque(T.init_deque(8, device="cpu"),
                                 torch.from_numpy(ops), torch.from_numpy(params))
    assert_state_same(js, ts)
    assert_same(jr, tr.numpy())
    assert int(T.state_to_numpy(ts)[1][1][0]) < 0


def test_pack_unpack_cas():
    for e, n in [(0, 0), (1, 2), (4095, 4095), (17, 4000)]:
        assert T.pack_cas(e, n) == J.pack_cas(e, n)
        assert T.unpack_cas(T.pack_cas(e, n)) == (e, n)
    for bad in [(-1, 0), (0, 4096), (4096, 1)]:
        with pytest.raises(ValueError):
            T.pack_cas(*bad)
    with pytest.raises(ValueError):
        T.unpack_cas(4096 * 4096)


def test_map_bucket_matches_host_and_jax():
    """The port's int64-masked hash equals the numpy twin and JAX's uint32
    hash, on negative keys and keys >= 2^31 cut to 32 bits."""
    keys = np.array([0, 1, 7, -1, -2**31, 2**31 - 1, 123456789, -98765], np.int64)
    wide = np.array([2**31, 2**32 - 1, 2**32 + 5, 2**40 + 3], np.int64)
    for nb in (1, 7, 64, 1024):
        dev = T.map_bucket(torch.from_numpy(keys), nb).numpy()
        np.testing.assert_array_equal(dev, T.map_bucket_host(keys.astype(np.uint32), nb))
        assert_same(np.asarray(J.map_bucket(jnp.asarray(keys.astype(np.int32)), nb)), dev)
        wrapped = wide.astype(np.uint32).astype(np.int32)
        np.testing.assert_array_equal(
            T.map_bucket(torch.from_numpy(wide), nb).numpy(),
            np.asarray(J.map_bucket(jnp.asarray(wrapped), nb)))
        np.testing.assert_array_equal(
            T.map_bucket_host(keys.astype(np.uint32), nb),
            J.map_bucket_host(keys.astype(np.uint32), nb))


def test_map_geometry_and_full_bucket():
    assert T.map_geometry(64) == J.map_geometry(64) == (8, 8)
    assert T.map_geometry(4) == (4, 1)
    with pytest.raises(ValueError):
        T.map_geometry(12)


@pytest.mark.parametrize("kind,nop", KINDS)
def test_state_numpy_round_trip(kind, nop):
    """``state_from_numpy`` / ``state_to_numpy`` carry a non-empty JAX state
    across with its dtypes, shapes and bytes (single and shard-stacked)."""
    rng = np.random.default_rng(3)
    jstate = J.STRUCTS[kind].init(32)
    keys, ops, params = _batch(rng, kind, nop, 16)
    if kind == "map":
        jstate, _, _ = J.combine_map(jstate, jnp.asarray(keys), jnp.asarray(ops),
                                     jnp.asarray(params))
    else:
        jstate, _, _ = J.STRUCTS[kind].combine(jstate, jnp.asarray(ops),
                                               jnp.asarray(params))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    tstate = T.state_from_numpy(kind, leaves, device="cpu")
    assert isinstance(tstate, T.STRUCTS[kind].state_cls)
    assert_state_same(jstate, tstate)
    assert tstate.epoch.dtype == torch.int32 and tstate.epoch.dim() == 0
    stacked = J.init_sharded(kind, 3, 16)
    tst = T.state_from_numpy(
        kind, [np.asarray(x) for x in jax.tree_util.tree_leaves(stacked)], device="cpu")
    assert_state_same(stacked, tst)
    assert_state_same(J.shard_slice(stacked, 1), T.shard_slice(tst, 1))
    assert_state_same(stacked, T.init_sharded(kind, 3, 16, device="cpu"))
    with pytest.raises(ValueError):
        T.state_from_numpy(kind, leaves[:-1], device="cpu")


@pytest.mark.parametrize("kind", ["stack", "queue", "deque", "map"])
def test_state_from_contents_matches_jax(kind):
    contents = ([(5, 1.5), (3, 2.0), (2**20, 3.0)] if kind == "map"
                else [1.0, 2.5, -0.0, 4.0])
    for epoch in (0, 2, 6):
        assert_state_same(J.state_from_contents(kind, contents, 16, epoch),
                          T.state_from_contents(kind, contents, 16, epoch, device="cpu"))


def test_stack_shards_inverse_of_slice():
    st = T.init_sharded("queue", 4, 8, device="cpu")
    st.values[2, 3] = 9.0
    back = T.stack_shards([T.shard_slice(st, i) for i in range(4)])
    for a, b in zip(st.leaves(), back.leaves()):
        assert torch.equal(a, b)


def test_announce_ring_matches_jax():
    rng = np.random.default_rng(5)
    jr = J.init_announce_ring(16)
    tr = T.init_announce_ring(16, device="cpu")
    start = 0
    for n in (5, 7, 9):  # the third span wraps the ring
        keys = rng.integers(-50, 2**31 - 1, n).astype(np.int32)
        ops = rng.integers(0, 3, n).astype(np.int32)
        params = rng.random(n).astype(np.float32)
        jr = J.ring_announce(jr, jnp.asarray(keys), jnp.asarray(ops), jnp.asarray(params))
        tr = T.ring_announce(tr, torch.from_numpy(keys), torch.from_numpy(ops),
                             torch.from_numpy(params))
        for a, b in zip(J.ring_drain(jr, start, n), T.ring_drain(tr, start, n)):
            assert_same(np.asarray(a), b.numpy())
        start += n
    assert_state_same(jr, tr)
    assert T.ring_has_room(16, 21, 14, 9) == J.ring_has_room(16, 21, 14, 9)
    assert T.ring_has_room(16, 21, 12, 9) == J.ring_has_room(16, 21, 12, 9)
    with pytest.raises(ValueError):
        T.init_announce_ring(12, device="cpu")


def test_lane_tables_match_jax():
    ops = np.arange(-1, 7, dtype=np.int32)
    for kind in T.STRUCTS:
        np.testing.assert_array_equal(
            T.lane_of_ops(kind, torch.from_numpy(ops)).numpy(),
            np.asarray(J.lane_of_ops(kind, jnp.asarray(ops))))
        np.testing.assert_array_equal(T.lane_of_ops_host(kind, ops),
                                      J.lane_of_ops_host(kind, ops))
    assert T.KIND_CODES == J.KIND_CODES
    assert {k: s.n_opcodes for k, s in T.STRUCTS.items()} == {
        k: s.n_opcodes for k, s in J.STRUCTS.items()}
