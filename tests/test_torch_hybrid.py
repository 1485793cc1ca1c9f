"""The port's hybrid family (``zamba2-7b``: mamba2's SSD, a shared attention
block) and its rolling-window decode against the JAX package's, on the CPU.

The reduced ``zamba2-7b`` and ``tests/test_models.py``'s ``hybrid`` variant
run in f32 with the JAX package's ``init_params(PRNGKey(0))`` carried across
by ``params_from_numpy``.  ``ssd_chunked`` and ``mamba2_block`` match the
reference's to atol = rtol = 1e-5 (one chunk, several, a ragged S taken as one chunk, an
initial state, a masked triangle that overflows to inf); the models'
forward, prefill, decode steps and greedy tokens to 1e-4.  The rolling
window (``init_cache(window=)``, ``decode_step(window=)``) matches the
reference's ring token by token, for the dense and hybrid families, and the
port's own windowed forward, as ``tests/test_models.py`` checks the
reference.  The launcher serves the reference launcher's greedy tokens with
and without ``--window`` (the reference's ring over the prefill's
``max_len``-wide cache included).  ``input_specs`` builds the reference's
shapes and dtypes on the meta device; ``chunked_attention`` and the flash
kernel's plain path at head dim 112 match the reference's.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.configs import shapes as JSH  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ops import chunked_attention as j_chunked  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.configs import shapes as TSH  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention, chunked_attention  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.launch.tuned import apply_tuning  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
# tests/test_models.py's hybrid variant (head dim 8: the flash kernel has no
# instance for it and runs it zero-padded to 16; on the CPU the plain version)
VARIANT = dict(name="hybrid", family="hybrid", n_layers=5, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=64, vocab=64, ssm_version=2, ssm_state=8, ssm_head_dim=16,
               attn_every=2, remat="none", dtype="float32")
DENSE = dict(name="dense", family="dense", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab=64, remat="none", dtype="float32")
CASES = ["zamba2-7b", "hybrid"]
B, S, MAX_LEN, ATOL = 2, 12, 24, 1e-4
SSD_TOL = 1e-5


def _cfgs(case):
    if case in ("hybrid", "dense"):
        kw = VARIANT if case == "hybrid" else DENSE
        return JModelConfig(**kw), ModelConfig(**kw)
    return JCFG.get_reduced(case), TCFG.get_reduced(case)


def _backend(cfg):
    return "kernel" if cfg.hd() <= FK.HEAD_DIMS[-1] else "ref"


@functools.lru_cache(maxsize=None)
def _jax_tree(case):
    """The reference's ``init_params(PRNGKey(0))`` as numpy, made once."""
    init = jax.jit(JM.init_params, static_argnums=0)
    return jax.device_get(init(_cfgs(case)[0], jax.random.PRNGKey(0)))


def _setup(case):
    jcfg, tcfg = _cfgs(case)
    tree = _jax_tree(case)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg, "cpu"),
            tokens)


@functools.lru_cache(maxsize=None)
def _jax_fns(case, window=0):
    """The reference's forward, prefill and decode step, jitted once."""
    jcfg = _cfgs(case)[0]
    return (jax.jit(lambda p, b: JM.forward(p, jcfg, b)),
            jax.jit(lambda p, b: JM.prefill(p, jcfg, b, MAX_LEN)),
            jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b, window=window)))


def _jt(tokens):
    return {"tokens": jnp.asarray(tokens, jnp.int32)}


def _tt(tokens):
    return {"tokens": torch.from_numpy(np.asarray(tokens))}


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _ssd_close(got, want):
    """The SSD pieces' tolerance: atol = rtol = 1e-5 (f32 on both sides,
    summed in other orders; outputs reach about 5)."""
    _close(got, want, SSD_TOL, SSD_TOL)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ----------------------------------------------------------------- configs
def test_config_matches_jax():
    """The copied configs carry the reference's values in every field the
    port keeps; the full config is 81 layers, 13 groups of 6 and a tail of
    3, head dim 112, and 6,750,530,784 parameters as the reference counts
    them; the launcher's tuning sets the reference's two sharding levers,
    inert on one card, and nothing else."""
    for getter in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(JCFG, getter)("zamba2-7b"), getattr(TCFG, getter)("zamba2-7b")
        for f in dataclasses.fields(ModelConfig):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (getter, f.name)
        assert (tcfg.hd(), tcfg.d_inner(), tcfg.param_count()) == (
            jcfg.hd(), jcfg.d_inner(), jcfg.param_count())
    full = TCFG.get_config("zamba2-7b")
    assert full.param_count() == 6_750_530_784 and full.hd() == 112
    assert TM._hybrid_groups(full) == (13, 3)
    assert apply_tuning(full) == dataclasses.replace(full, attn_seq_shard=True,
                                                     seq_parallel_resid=True)


def _flat_spec(tcfg):
    flat = jax.tree_util.tree_flatten_with_path(
        TM.param_spec(tcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
    return {jax.tree_util.keystr(k): (tuple(v[0]), str(v[1])[6:]) for k, v in flat}


@pytest.mark.parametrize("which", ["reduced", "full", "variant"])
def test_param_spec_matches_jax_tree(which):
    """``param_spec``'s names, shapes and dtypes equal the reference's
    ``init_params`` tree (the full config's by ``abstract_params``): the
    mamba2 leaves stacked (G, attn_every) in ``mamba_groups``, the tail's
    (tail,), ``shared_attn`` unstacked; ``A_log`` and ``D_skip`` f32."""
    jcfg, tcfg = {"reduced": (JCFG.get_reduced("zamba2-7b"), TCFG.get_reduced("zamba2-7b")),
                  "full": (JCFG.get_config("zamba2-7b"), TCFG.get_config("zamba2-7b")),
                  "variant": _cfgs("hybrid")}[which]
    flat = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in flat}
    got = _flat_spec(tcfg)
    assert got == want
    g, tail = TM._hybrid_groups(tcfg)
    assert got["['mamba_groups']['mamba']['A_log']"] == ((g, tcfg.attn_every,
                                                         tcfg.d_inner() // tcfg.ssm_head_dim),
                                                        "float32")
    assert ("['mamba_tail']['norm1']" in got) == bool(tail)
    assert got["['shared_attn']['attn']['wq']"][0] == (tcfg.d_model, tcfg.n_heads * tcfg.hd())


@pytest.mark.parametrize("case", CASES)
def test_params_and_caches_match_jax_trees(case):
    """The reference's tree crosses unchanged, the port's own init has its
    shapes and dtypes, and ``init_cache`` (with and without a window) the
    reference's names, shapes and dtypes."""
    jcfg, tcfg, _, tparams, _ = _setup(case)
    tree = _jax_tree(case)
    own = TM.init_params(tcfg, seed=0, device="cpu")
    for params in (tparams, own):
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree)),
                        jax.tree_util.tree_leaves(params)):
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype)[6:]
    own_g = own["mamba_groups"]["mamba"]
    assert bool((own_g["A_log"] == 0).all()) and bool((own_g["D_skip"] == 1).all())
    assert bool((own_g["dt_bias"] == 0).all()) and bool((own_g["conv_b"] == 0).all())
    for window in (0, 6):
        want = JM.init_cache(jcfg, B, MAX_LEN, window=window)
        got = TM.init_cache(tcfg, B, MAX_LEN, window=window, device="cpu")
        assert set(got) == set(want) and got["len"] == 0
        for k in want:
            if k != "len":
                assert (tuple(got[k].shape), str(got[k].dtype)[6:]) == (
                    want[k].shape, str(want[k].dtype)), k
        assert got["attn_k"].shape[2] == (window or MAX_LEN)


# --------------------------------------------------------------- the SSD
def _ssd_inputs(seed, b, s, h, p, n, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    xh = _pair(rng, (b, s, h, p))
    raw = rng.standard_normal((b, s, h)).astype(np.float32) * dt_scale
    dt = np.log1p(np.exp(raw)).astype(np.float32)  # softplus: positive steps
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    return (xh, (jnp.asarray(dt), torch.from_numpy(dt)),
            (jnp.asarray(a_log), torch.from_numpy(a_log.copy())),
            _pair(rng, (b, s, n)), _pair(rng, (b, s, n)))


@pytest.mark.parametrize("s,chunk,with_state", [
    (16, 16, False),  # one chunk
    (32, 8, False),   # four chunks
    (37, 37, False),  # a ragged S: one chunk of S (the block's rule)
    (32, 8, True),    # started from a state
])
def test_ssd_chunked_matches_jax(s, chunk, with_state):
    ins = _ssd_inputs(s + chunk, 2, s, 3, 4, 5)
    init = None
    if with_state:
        init = _pair(np.random.default_rng(9), (2, 3, 4, 5))
    jy, jfin = JMB.ssd_chunked(*(j for j, _ in ins), chunk=chunk,
                               init_state=None if init is None else init[0])
    ty, tfin = TMB.ssd_chunked(*(t for _, t in ins), chunk,
                               init_state=None if init is None else init[1])
    assert ty.dtype == tfin.dtype == torch.float32 and ty.shape == (2, s, 3, 4)
    _ssd_close(ty, jy)
    _ssd_close(tfin, jfin)


def test_ssd_masked_triangle_overflows_to_inf_but_stays_finite():
    """Large steps make the cumulative log decay of a chunk reach about
    -250, so exp(cum_t - cum_tau) above the diagonal overflows to inf: the
    select keeps the output finite (a 0/1 mask would give inf * 0 = NaN),
    equal to the reference's."""
    ins = _ssd_inputs(3, 1, 128, 2, 4, 4, dt_scale=0.1)
    (jx, tx), _, (ja, ta), (jb, tb), (jc, tc) = ins
    dt = np.full((1, 128, 2), 2.0, np.float32)
    a_log = np.zeros(2, np.float32)  # A = -1, zamba2's init
    cum = -np.cumsum(dt[0, :, 0])
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(cum[0] - cum[-1])))
    jy, jfin = JMB.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a_log), jb, jc, chunk=128)
    ty, tfin = TMB.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(a_log), tb, tc, 128)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(tfin).all())
    _ssd_close(ty, jy)
    _ssd_close(tfin, jfin)


def test_ssd_gradient_stays_finite_where_the_triangle_overflows():
    """On the inputs above, the reference's gradient is NaN (exp's
    gradient is grad * inf above the diagonal, and its select after exp
    zeroes grad, not the product); the port selects before exp too, so
    every gradient is finite, and its output has the bits of exp then the
    select alone."""
    ins = _ssd_inputs(3, 1, 128, 2, 4, 4, dt_scale=0.1)
    (jx, tx), _, _, (jb, tb), (jc, tc) = ins
    dt = np.full((1, 128, 2), 2.0, np.float32)
    a_log = np.zeros(2, np.float32)
    w = np.random.default_rng(5).standard_normal((1, 128, 2, 4)).astype(np.float32)

    def jloss(x, d, a, b, c):
        return jnp.sum(JMB.ssd_chunked(x, d, a, b, c, chunk=128)[0] * w)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jx, jnp.asarray(dt), jnp.asarray(a_log),
                                                  jb, jc)
    assert any(bool(jnp.isnan(g).any()) for g in jg)
    leaves = [t.clone().requires_grad_(True) for t in (
        tx, torch.from_numpy(dt), torch.from_numpy(a_log), tb, tc)]
    y, _ = TMB.ssd_chunked(*leaves, 128)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # the forward's bits: exp of the whole triangle, then the select
    cum = torch.cumsum(torch.from_numpy(dt) * -1.0, dim=1).reshape(1, 1, 128, 2)
    with np.errstate(over="ignore"):
        old = torch.where(torch.ones(128, 128, dtype=torch.bool).tril()[None, None, :, :, None],
                          torch.exp(cum[:, :, :, None] - cum[:, :, None, :]), 0.0)
    tri = torch.ones(128, 128, dtype=torch.bool).tril()[None, None, :, :, None]
    new = torch.where(tri, torch.exp(torch.where(tri, cum[:, :, :, None] - cum[:, :, None, :],
                                                 -torch.inf)), 0.0)
    assert torch.isinf(torch.exp(cum[:, :, :, None] - cum[:, :, None, :])).any()
    assert torch.equal(old.view(torch.int32), new.view(torch.int32))


def _block_params(seed=0):
    """One mamba2 layer of the reduced zamba2, drawn with non-zero biases
    and decays (the reference's init has them at zero)."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    p = jax.tree.map(lambda x: np.asarray(x[0, 0]), _jax_tree("zamba2-7b")["mamba_groups"])
    p = dict(p["mamba"])
    rng = np.random.default_rng(seed)
    for name in ("dt_bias", "A_log", "conv_b"):
        p[name] = (rng.standard_normal(p[name].shape) * 0.3).astype(np.float32)
    p["norm_scale"] = (1 + rng.standard_normal(p["norm_scale"].shape) * 0.1).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("mode", ["prefill", "decode step", "prefill with a state"])
def test_mamba2_block_matches_jax(mode):
    jcfg, tcfg, jp, tp = _block_params()
    rng = np.random.default_rng(4)
    s = 1 if mode == "decode step" else 20
    jx, tx = _pair(rng, (B, s, tcfg.d_model), 0.5)
    state = None
    if mode != "prefill":
        di, n, hp = tcfg.d_inner(), tcfg.ssm_state, tcfg.ssm_head_dim
        h = _pair(rng, (B, di // hp, hp, n), 0.3)
        tail = _pair(rng, (B, tcfg.d_conv - 1, di + 2 * n), 0.5)
        state = ((h[0], tail[0]), (h[1], tail[1]))
    jout, (jfin, jtail) = JMB.mamba2_block(jx, jp, jcfg, None if state is None else state[0])
    tout, (tfin, ttail) = TMB.mamba2_block(tx, tp, tcfg, None if state is None else state[1])
    assert tfin.dtype == torch.float32 and tfin.shape == (B, 8, 16, 16)
    _ssd_close(tout, jout)
    _ssd_close(tfin, jfin)
    _close(ttail, jtail, 0)
    if mode == "prefill with a state":  # the SSD starts from the state, unlike mamba1's scan
        zero, _ = TMB.mamba2_block(tx, tp, tcfg, (torch.zeros_like(state[1][0]), state[1][1]))
        assert float((zero - tout).abs().max()) > 1e-3


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    want, _ = _jax_fns(case)[0](jparams, _jt(tokens))
    got, aux = TM.forward(tparams, tcfg, _tt(tokens), backend=_backend(tcfg))
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case):
    """Prefill of half the prompt (its logits and every cache leaf), then
    six decode steps, against the reference."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    _, jpre, jdec = _jax_fns(case)
    half = S // 2
    jlast, jcache = jpre(jparams, _jt(tokens[:, :half]))
    tlast, tcache = TM.prefill(tparams, tcfg, _tt(tokens[:, :half]), MAX_LEN,
                               backend=_backend(tcfg))
    _close(tlast, jlast)
    for name in jcache:
        if name != "len":
            _close(tcache[name], jcache[name])
    for i in range(half, S):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]),
                                    backend=_backend(tcfg))
        _close(tl, jl)
    for name in jcache:
        if name != "len":
            _close(tcache[name], jcache[name])
    assert tcache["len"] == int(jcache["len"]) == S


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_jax(case):
    """The steps of both packages decode the same greedy tokens (the port's
    quantum step against the reference's serve steps)."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    jpre = jax.jit(JST.make_prefill_step(jcfg, MAX_LEN))
    jserve = jax.jit(JST.make_serve_step(jcfg))
    last, cache = jpre(jparams, _jt(tokens[:, :6]))
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok[:, 0])]
    for _ in range(8):
        out, cache = jserve(jparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    backend = _backend(tcfg)
    last, cache = TST.make_prefill_step(tcfg, MAX_LEN, backend)(tparams, _tt(tokens[:, :6]))
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    got = [tok[:, 0].numpy()]
    out, cache = TST.make_quantum_step(tcfg, quantum=8, backend=backend)(tparams, cache, tok)
    got += [out["tokens"][:, i].numpy() for i in range(8)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("case", CASES)
def test_incremental_decode_matches_forward(case):
    """Twin of ``tests/test_models.py``'s check for the hybrid: decode from
    an empty cache, token by token, reproduces the port's full forward."""
    _, tcfg, _, tparams, tokens = _setup(case)
    ref, _ = TM.forward(tparams, tcfg, _tt(tokens), backend=_backend(tcfg))
    cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    outs = []
    for i in range(S):  # the first step (length 0) attends as a prefill does
        lg, cache = TM.decode_step(tparams, tcfg, cache, _tt(tokens[:, i:i + 1]),
                                   backend=_backend(tcfg))
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_forward(case):
    """Twin of ``tests/test_models.py``'s check: a prefill of half the
    sequence, then one decode step, reproduce the full forward."""
    _, tcfg, _, tparams, tokens = _setup(case)
    backend = _backend(tcfg)
    ref, _ = TM.forward(tparams, tcfg, _tt(tokens), backend=backend)
    half = S // 2
    last, cache = TM.prefill(tparams, tcfg, _tt(tokens[:, :half]), S + 4, backend=backend)
    np.testing.assert_allclose(last[:, 0].numpy(), ref[:, half - 1].numpy(), rtol=2e-2,
                               atol=2e-3)
    lg, _ = TM.decode_step(tparams, tcfg, cache, _tt(tokens[:, half:half + 1]))
    np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, half].numpy(), rtol=2e-2, atol=2e-3)


# ------------------------------------------------------ the rolling window
def _windowed_forward(params, cfg, tokens, w):
    """The port's full forward with every self-attention over a sliding
    window of ``w`` keys (``attention_block(window=)``: plain PyTorch)."""
    h = TM._embed(params, cfg, _tt(tokens))
    positions = torch.arange(tokens.shape[1])

    def attn(hh, bp):
        return TM._self_block(hh, bp, cfg, positions, backend="ref", window=w)[0]

    if cfg.family == "hybrid":
        groups, tail = TM._hybrid_groups(cfg)
        for g in range(groups):
            for j in range(cfg.attn_every):
                h, _ = TM._mamba_layer(h, TM._layer(params["mamba_groups"], (g, j)), cfg,
                                       backend="ref")
            h = attn(h, params["shared_attn"])
        for i in range(tail):
            h, _ = TM._mamba_layer(h, TM._layer(params["mamba_tail"], i), cfg, backend="ref")
    else:
        for i in range(cfg.n_layers):
            h = attn(h, TM._layer(params["blocks"], i))
    return TM._logits(params, cfg, h, "ref")


@pytest.mark.parametrize("case", ["dense", "hybrid", "zamba2-7b"])
def test_window_decode_matches_jax_and_a_windowed_forward(case):
    """From ``init_cache(window=W)``, every token decoded with
    ``decode_step(window=W)``: logits and rings equal the reference's
    token by token (1e-4), and the logits equal the port's windowed forward
    (twin of ``test_ring_window_decode_matches_windowed_forward``)."""
    w = 6
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    jdec = _jax_fns(case, w)[2]
    jcache = JM.init_cache(jcfg, B, MAX_LEN, window=w)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, window=w, device="cpu")
    ring = "attn_k" if tcfg.family == "hybrid" else "k"
    outs = []
    for i in range(S):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]), window=w)
        _close(tl, jl)
        _close(tcache[ring], jcache[ring])
        outs.append(tl)
    assert tcache[ring].shape[-3] == w
    ref = _windowed_forward(tparams, tcfg, tokens, w)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), rtol=2e-2, atol=2e-3)
    # and the window does mask: the full forward differs once S > W
    full, _ = TM.forward(tparams, tcfg, _tt(tokens), backend="ref")
    assert float((full[:, -1] - outs[-1][:, 0]).abs().max()) > 1e-3


def test_ring_shifts_and_appends_in_place():
    """A window step shifts each ring left by one and writes this token's
    roped K at slot W - 1, in place: the other slots are bit-equal to the
    previous ones, moved."""
    _, tcfg, _, tparams, tokens = _setup("zamba2-7b")
    cache = TM.init_cache(tcfg, B, MAX_LEN, window=4, device="cpu")
    k = cache["attn_k"]
    for i in range(6):
        before = k.clone()
        _, cache = TM.decode_step(tparams, tcfg, cache, _tt(tokens[:, i:i + 1]), window=4)
        assert cache["attn_k"] is k
        assert torch.equal(k[:, :, :-1], before[:, :, 1:])
        assert bool(k[:, :, -1].abs().sum(-1).gt(0).all())


def test_rope_at_long_500k_positions():
    """At ``long_500k``'s positions the rotary angles equal the reference's
    bit for bit (the same f32 inverse frequencies times the same f32
    positions); cos / sin of angles up to 5.2e5 rad agree within 2e-6
    (XLA's and torch's transcendental functions may differ in the last
    bits there)."""
    pos = np.array([0, 1, 4095, 524_280, 524_287], np.int32)
    for hd, theta in ((112, 10_000.0), (16, 10_000.0), (128, 1e6)):
        jc, js = JL.rope_freqs(hd, theta, jnp.asarray(pos))
        tc, ts = L.rope_freqs(hd, theta, torch.from_numpy(pos.astype(np.int64)))
        inv = L._inv_freqs(hd, theta, torch.device("cpu"))
        want = np.asarray(jnp.asarray(pos)[:, None].astype(jnp.float32)
                          * (1.0 / (theta ** (np.arange(0, hd, 2) / hd)))[None])
        np.testing.assert_array_equal((torch.from_numpy(pos).float()[:, None] * inv).numpy(), want)
        _close(tc, jc, 2e-6)
        _close(ts, js, 2e-6)


@pytest.mark.parametrize("case", ["zamba2-7b", "dense"])
def test_window_decode_near_the_last_long_500k_position(case):
    """Decode steps at ``len`` 524,280..524,287 on a window cache filled by
    eight earlier window steps: logits within 1e-4 of the reference's (the
    rotary's cos / sin agree to 2e-6 there, see above; f32 elsewhere)."""
    w, far = 8, 524_280
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    jdec = _jax_fns(case, w)[2]
    jcache = JM.init_cache(jcfg, B, MAX_LEN, window=w)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, window=w, device="cpu")
    for i in range(8):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        _, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]), window=w)
    jcache = dict(jcache, len=jnp.asarray(far, jnp.int32))
    tcache = dict(tcache, len=far)
    for i in range(8):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]), window=w)
        _close(tl, jl)
    assert tcache["len"] == int(jcache["len"]) == 524_288


def test_serve_and_quantum_steps_take_the_window():
    """``make_serve_step(window=)`` and ``make_quantum_step(window=)`` run
    the reference's window steps: the same greedy tokens from a prefill at
    ``max_len`` == W (the insert-at-length layout is then the ring's)."""
    w = 8
    jcfg, tcfg, jparams, tparams, tokens = _setup("zamba2-7b")
    last, cache = jax.jit(JST.make_prefill_step(jcfg, w))(jparams, _jt(tokens[:, :w]))
    jserve = jax.jit(JST.make_serve_step(jcfg, window=w))
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = []
    for _ in range(6):
        out, cache = jserve(jparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    for quantum in (None, 6):
        last, cache = TST.make_prefill_step(tcfg, w)(tparams, _tt(tokens[:, :w]))
        tok = torch.argmax(last[:, -1], dim=-1)[:, None]
        if quantum:
            out, cache = TST.make_quantum_step(tcfg, quantum=6, window=w)(tparams, cache, tok)
            got = [out["tokens"][:, i].numpy() for i in range(6)]
        else:
            serve, got = TST.make_serve_step(tcfg, window=w), []
            for _ in range(6):
                out, cache = serve(tparams, cache, {"tokens": tok})
                tok = out["next_token"][:, None]
                got.append(tok[:, 0].numpy())
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        assert cache["attn_k"].shape[2] == w and cache["len"] == w + 6


# ------------------------------------------------------------ the launcher
# The reference launcher in a subprocess, its jitted steps wrapped so that
# it prints the greedy tokens it serves: each prefill's argmax and each
# step's next token, one JSON line a call
_REF_TOKENS = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    import repro.launch.serve as serve
    jit = jax.jit

    def spy(fn, *a, **kw):
        f = jit(fn, *a, **kw)
        name = getattr(fn, "__name__", "")
        def call(*args, **kwargs):
            out = f(*args, **kwargs)
            if name == "prefill_step":
                toks = np.argmax(np.asarray(out[0])[:, -1], -1)
            elif name == "serve_step":
                toks = np.asarray(out[0]["next_token"])
            else:
                return out
            print("TOKENS " + json.dumps([int(t) for t in toks]), flush=True)
            return out
        return call

    jax.jit = spy
    sys.argv = ["serve"] + sys.argv[1:]
    serve.main()
""")
SERVE_ARGV = ["--arch", "zamba2-7b", "--reduced", "--batch", "2", "--prompt-len", "6",
              "--gen", "4", "--sessions", "4"]


def test_launcher_serves_the_reference_tokens():
    """``python -m repro.launch.serve --arch zamba2-7b --reduced`` (a
    subprocess), without and with ``--window 8``, and the port's launcher
    with the same flags and the reference's ``init_params(PRNGKey(0))``:
    the same greedy tokens, batch by batch, and the same report lines
    (``test_window_after_a_wider_prefill_keeps_the_reference_quirk`` shows
    what ``--window`` decodes over)."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    runs = {name: SERVE_ARGV + extra for name, extra in (("plain", []),
                                                          ("window", ["--window", "8"]))}
    procs = {name: subprocess.Popen([sys.executable, "-c", _REF_TOKENS, *argv], cwd=REPO,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name, argv in runs.items()}
    jcfg, tcfg = JCFG.get_reduced("zamba2-7b"), TCFG.get_reduced("zamba2-7b")
    params = params_from_numpy(_jax_tree("zamba2-7b"), tcfg, "cpu")
    served = {}
    for name, argv in runs.items():
        got = []

        def hook(sids, prompts, last, tokens):
            got.extend(tokens[:, i].tolist() for i in range(tokens.shape[1]))

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = TV.serve(TV.build_parser().parse_args(argv + ["--device", "cpu"]),
                           params=params, hook=hook)
        stdout, stderr = procs[name].communicate(timeout=600)
        assert procs[name].returncode == 0, stderr
        want = [json.loads(line[7:]) for line in stdout.splitlines()
                if line.startswith("TOKENS ")]
        assert out["batches"] == 2 and len(want) == 8
        assert got == want, name
        served[name] = got

        def summary(text):
            return [line.split(" tok in ")[0] for line in text.splitlines()
                    if not line.startswith(("TOKENS ", "model:"))]

        assert summary(buf.getvalue()) == summary(stdout), name


def test_window_after_a_wider_prefill_keeps_the_reference_quirk():
    """As the launcher runs it: a prefill into an 18-wide insert-at-length
    cache (prompt 6 + gen 4 + 8), then ``decode_step(window=8)``.  The ring
    takes its width from the cache (18, not 8), so its valid right end
    holds zeros where the prompt's keys should be, and the step's logits
    move away from the plain decode step's; the port's equal the
    reference's all the same, and its ring is the reference's."""
    jcfg, tcfg, jparams, tparams, tokens = _setup("zamba2-7b")
    width, step = 18, _jt(tokens[:, 6:7])
    jlast, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, width))(
        jparams, _jt(tokens[:, :6]))
    want = {w: JM.decode_step(jparams, jcfg, jcache, step, window=w) for w in (0, 8)}
    got = {}
    for w in (0, 8):
        _, cache = TM.prefill(tparams, tcfg, _tt(tokens[:, :6]), width)
        got[w] = TM.decode_step(tparams, tcfg, cache, _tt(tokens[:, 6:7]), window=w)
        _close(got[w][0], want[w][0])
        _close(got[w][1]["attn_k"], want[w][1]["attn_k"])
    assert got[8][1]["attn_k"].shape[2] == width
    assert float((got[8][0] - got[0][0]).abs().max()) > 1e-3


# ------------------------------------------------------------- input specs
_PAIRS = [(a, s) for a in TCFG.ARCH_IDS for s in TSH.SHAPES if TSH.supports(a, s)]


def test_shapes_match_jax():
    assert TSH.SHAPES == {k: TSH.ShapeCfg(**dataclasses.asdict(v)) for k, v in JSH.SHAPES.items()}
    assert TSH.LONG_CONTEXT_ARCHS == JSH.LONG_CONTEXT_ARCHS
    assert len(_PAIRS) == 4 * len(TCFG.ARCH_IDS) - 8
    assert all(TSH.supports(a, s) == JSH.supports(a, s) for a in TCFG.ARCH_IDS
               for s in TSH.SHAPES)


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_input_specs_match_jax(arch):
    """For every shape the arch supports, ``input_specs`` builds the
    reference's leaves (names, shapes, dtypes) as meta tensors, the decode
    cache by ``init_cache`` on the meta device (``long_500k``: 4,096-wide
    windows), allocating nothing."""
    jcfg, tcfg = JCFG.get_config(arch), TCFG.get_config(arch)
    for shape in TSH.SHAPES:
        if not TSH.supports(arch, shape):
            continue
        want = jax.tree_util.tree_flatten_with_path(JSH.input_specs(jcfg, shape))[0]
        want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in want}
        got = jax.tree_util.tree_flatten_with_path(TSH.input_specs(tcfg, shape))[0]
        got = {jax.tree_util.keystr(k): v for k, v in got}
        assert set(got) == set(want), shape
        for k, v in got.items():
            if k.endswith("['len']"):
                assert v == 0 and want[k] == ((), "int32")
                continue
            assert v.device.type == "meta", (shape, k)
            assert (tuple(v.shape), str(v.dtype)[6:]) == want[k], (shape, k)
        if arch == "zamba2-7b" and shape == "long_500k":
            assert got["['cache']['attn_k']"].shape == (13, 1, 4096, 32, 112)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,s,t,blk", [(True, 64, 64, 16), (False, 24, 48, 16),
                                            (True, 48, 48, 64)])
def test_chunked_attention_matches_jax(causal, s, t, blk):
    rng = np.random.default_rng(s + t)
    jq, tq = _pair(rng, (2, s, 6, 16), 0.5)
    jk, tk = _pair(rng, (2, t, 2, 16), 0.5)
    jv, tv = _pair(rng, (2, t, 2, 16), 0.5)
    want = j_chunked(jq, jk, jv, causal=causal, blk_k=blk)
    got = chunked_attention(tq, tk, tv, causal=causal, blk_k=blk)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    _close(got, want, 1e-5)
    if causal and s == t:
        _close(got, attention(tq, tk, tv, causal=True, backend="ref"), 1e-5)


@pytest.mark.parametrize("causal,hq,hkv", [(True, 2, 2), (False, 4, 2)])
def test_flash_head_dim_112_matches_pallas(causal, hq, hkv):
    """Head dim 112 (zamba2's), and 48, which the kernel has no instance for
    (the card pads it to 64): the wrapper's plain path against the
    reference's Pallas kernel in interpret mode; a head dim past the widest
    instance (160) is refused on the CPU as on the card."""
    assert 112 in FK.HEAD_DIMS and 48 not in FK.HEAD_DIMS
    for hd in (112, 48):
        rng = np.random.default_rng(hd)
        jq, tq = _pair(rng, (1, 128, hq, hd), 0.5)
        jk, tk = _pair(rng, (1, 128, hkv, hd), 0.5)
        jv, tv = _pair(rng, (1, 128, hkv, hd), 0.5)
        want = j_flash(jq, jk, jv, causal=causal, blk_q=64, blk_k=64, interpret=True)
        FK.reset_launches()
        got = FK.flash_attention(tq, tk, tv, causal=causal)
        assert FK.LAUNCHES["flash_attention"] == 0 and got.shape == tq.shape
        _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="head dim 160"):
        FK.flash_attention(*([torch.randn(1, 4, 2, 160)] * 3))
