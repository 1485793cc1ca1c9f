"""The port's router against the JAX reference: ``route_batch``'s 7-tuple
bit for bit (stable ranks, overflow, ``OP_NONE`` lanes, a custom table),
``shard_of_keys`` / ``route_keys_host``, and the 32-bit cut of keys that the
reference (64-bit types off) applies to keys >= 2^31 and negative keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import dfc_shard as JS  # noqa: E402
from repro_torch.runtime import dfc_shard as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (what, a, b)


def _route_both(keys, ops, params, n_shards, lanes, table=None):
    j = JS.route_batch(
        jnp.asarray(keys.astype(np.int32)), jnp.asarray(ops), jnp.asarray(params),
        n_shards=n_shards, lanes=lanes,
        table=None if table is None else jnp.asarray(table))
    t = TS.route_batch(
        torch.from_numpy(keys), torch.from_numpy(ops), torch.from_numpy(params),
        n_shards=n_shards, lanes=lanes,
        table=None if table is None else torch.from_numpy(table))
    assert len(j) == len(t) == 7
    for i, (a, b) in enumerate(zip(j, t)):
        assert_same(np.asarray(a), b.numpy(), f"route output {i}")
    return t


@pytest.mark.parametrize("n_shards,lanes,b", [(4, 4, 11), (8, 6, 64), (5, 32, 40)])
def test_route_batch_matches_jax(n_shards, lanes, b):
    """Random batches with OP_NONE lanes and overflowing hot shards."""
    rng = np.random.default_rng(n_shards * 100 + lanes)
    for _ in range(3):
        keys = rng.integers(0, 20, b).astype(np.int64)
        ops = rng.integers(0, 3, b).astype(np.int32)
        params = (rng.random(b) * 100).round(2).astype(np.float32)
        _route_both(keys, ops, params, n_shards, lanes)
    # one hot key: every op past ``lanes`` overflows
    t = _route_both(np.full(b, 7, np.int64), np.ones(b, np.int32), params,
                    n_shards, lanes)
    assert int(t[5].numpy().sum()) == max(b - lanes, 0)


def test_route_stable_batch_order_and_none_lanes():
    keys = np.array([5, 9, 5, 5, 9, 5], np.int64)
    ops = np.array([1, 1, 0, 1, 1, 1], np.int32)
    params = np.arange(1.0, 7.0, dtype=np.float32)
    shard_ops, shard_params, shard, lane, ok, overflow, shard_keys = _route_both(
        keys, ops, params, 4, 4)
    s5 = int(TS.shard_of_keys_host([5], 4)[0])
    assert list(shard_params.numpy()[s5, :3]) == [1.0, 4.0, 6.0]
    assert list(ok.numpy()) == [True, True, False, True, True, True]
    assert int((shard_ops != 0).sum()) == 5
    assert list(shard_keys.numpy()[s5, :3]) == [5, 5, 5]


def test_route_custom_table_matches_jax():
    rng = np.random.default_rng(2)
    table = np.array([2, 0, 1, 2, 1, 0, 0, 2], np.int32)  # 8 buckets -> 3 shards
    keys = rng.integers(0, 1000, 48).astype(np.int64)
    ops = rng.integers(0, 5, 48).astype(np.int32)
    params = rng.random(48).astype(np.float32)
    _route_both(keys, ops, params, 3, 8, table=table)
    np.testing.assert_array_equal(TS.route_keys_host(keys, 3, table),
                                  JS.route_keys_host(keys, 3, table))


def test_keys_cut_to_32_bits():
    """Keys >= 2^31 and negative keys route as their low 32 bits, on the
    device and on the host, exactly as the reference sees them."""
    keys = np.array([2**31, 2**32 - 1, 2**32 + 7, -1, -2**31, 2**40 + 5, 3], np.int64)
    ops = np.ones(7, np.int32)
    params = np.arange(7, dtype=np.float32)
    t = _route_both(keys, ops, params, 8, 8)
    np.testing.assert_array_equal(t[2].numpy(), TS.shard_of_keys_host(keys, 8))
    np.testing.assert_array_equal(TS.shard_of_keys_host(keys, 8),
                                  JS.shard_of_keys_host(keys, 8))
    assert_same(np.asarray(JS.shard_of_keys(jnp.asarray(keys.astype(np.int32)), 8)),
                TS.shard_of_keys(torch.from_numpy(keys), 8).numpy())
    wrapped = keys.astype(np.uint32).astype(np.int32)
    assert list(t[6].numpy()[t[2].numpy(), t[3].numpy()]) == list(wrapped)


def test_shard_of_keys_host_device_agree():
    keys = np.random.default_rng(0).integers(-2**33, 2**33, 512)
    for n in (1, 3, 8, 256):
        np.testing.assert_array_equal(
            TS.shard_of_keys(torch.from_numpy(keys), n).numpy(),
            TS.shard_of_keys_host(keys, n))


def test_zipf_keys_same_draw():
    a = TS.zipf_keys(np.random.default_rng(4), 64, 4096, 1.1)
    b = JS.zipf_keys(np.random.default_rng(4), 64, 4096, 1.1)
    np.testing.assert_array_equal(a, b)
    assert (TS.zipf_keys(np.random.default_rng(1), 16, 10, 0.0) < 10).all()
