"""The port's gradient compression and elastic plan against the JAX
package's (twins of ``tests/test_distributed.py``): int8 codes and scales
bit for bit (``torch.round`` and ``jnp.round`` both round half to even),
error feedback's mass conservation, top-k's index set on distinct
magnitudes (on ties the two libraries may pick different entries), and
``plan_resize``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _compat import hypothesis, st  # noqa: E402

from repro.distributed import compression as JC  # noqa: E402
from repro.distributed.elastic import plan_resize as j_plan_resize  # noqa: E402
from repro_torch.distributed import compression as TC  # noqa: E402
from repro_torch.distributed.elastic import plan_resize  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("shape,scale", [((128, 64), 1.0), ((1000,), 3e-3), ((7, 5, 3), 50.0)])
def test_int8_matches_jax_bit_for_bit(shape, scale):
    g = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    g.reshape(-1)[:4] = [0.5, -1.5, 2.5, 0.0]  # halves: round to even on both sides
    jq, js = JC.quantize_int8(jnp.asarray(g))
    tq, ts = TC.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.asarray(ts, np.float32).tobytes() == np.asarray(js, np.float32).tobytes()
    back, jback = TC.dequantize_int8(tq, ts), JC.dequantize_int8(jq, js)
    assert back.numpy().tobytes() == np.asarray(jback).tobytes()
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(ts) * 0.5 + 1e-6


def test_int8_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])  # scale 1: the codes are the values
    q, s = TC.quantize_int8(g)
    assert float(s) == 1.0 and q.tolist() == [127, 0, 2, 2, 0, -2]


def _distinct(rng, n):
    """Values of distinct magnitudes (a shuffled ramp with random signs)."""
    mags = np.linspace(0.01, 1.0, n)
    return (rng.permutation(mags) * rng.choice([-1.0, 1.0], n)).astype(np.float32)


@pytest.mark.parametrize("n,frac", [(100, 0.05), (4096, 0.01), (33, 0.5)])
def test_topk_index_set_matches_jax(n, frac):
    g = _distinct(np.random.default_rng(n), n)
    jv, ji = JC.compress_topk(jnp.asarray(g), frac)
    tv, ti = TC.compress_topk(torch.from_numpy(g), frac)
    assert sorted(ti.tolist()) == sorted(np.asarray(ji).tolist())
    assert np.array_equal(TC.decompress_topk(tv, ti, (n,)).numpy(),
                          np.asarray(JC.decompress_topk(jv, ji, (n,))))


def test_error_feedback_matches_jax_and_conserves_mass():
    """sent + residual == grad + old residual (no gradient mass lost), and
    each round's sent and residual equal the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 32), "b": (128,)}
    grads = {k: _distinct(rng, int(np.prod(s))).reshape(s) for k, s in shapes.items()}
    tstate = TC.init_compression({k: torch.zeros(s) for k, s in shapes.items()})
    jstate = JC.init_compression({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        old = {k: v.clone() for k, v in tstate.residual.items()}
        tsent, tstate = TC.ef_compress_grads(tg, tstate, frac=0.05)
        jsent, jstate = JC.ef_compress_grads({k: jnp.asarray(v) for k, v in grads.items()},
                                             jstate, frac=0.05)
        for k in shapes:
            total = tsent[k] + tstate.residual[k]
            np.testing.assert_allclose(total.numpy(), (tg[k] + old[k]).numpy(), atol=1e-6)
            np.testing.assert_array_equal(tsent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_allclose(tstate.residual[k].numpy(),
                                       np.asarray(jstate.residual[k]), atol=1e-6)


def test_error_feedback_long_run_conservation():
    """Over T rounds: transmitted + residual == T g (nothing lost), and large
    coordinates transmit nearly their full due mass."""
    g = {"w": torch.linspace(0.01, 1.0, 100)}
    state = TC.init_compression(g)
    acc = torch.zeros(100)
    for _ in range(60):
        sent, state = TC.ef_compress_grads(g, state, frac=0.05)
        acc = acc + sent["w"]
    np.testing.assert_allclose((acc + state.residual["w"]).numpy(), (60 * g["w"]).numpy(),
                               rtol=1e-5)
    assert float(torch.min(acc[-10:] / (60 * g["w"][-10:]))) > 0.7


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(st.integers(1, 16), st.integers(1, 16), st.integers(0, 1000))
def test_plan_resize_matches_jax(n_old, n_new, cursor):
    old, new = list(range(n_old)), list(range(n_new))[::-1]
    plan, want = plan_resize(old, new, cursor), j_plan_resize(old, new, cursor)
    assert (plan.old_workers, plan.new_workers, plan.cursor_map) == (
        want.old_workers, want.new_workers, want.cursor_map)
    assert sorted(plan.cursor_map.values()) == list(range(cursor, cursor + n_new))
