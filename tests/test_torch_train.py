"""The port's training path against the JAX package's, on the CPU.

``adamw_update`` and ``lr_schedule`` against the reference's on a random
tree of f32 and bf16 leaves with f32 and bf16 states; ``loss_fn`` and every
leaf's gradient against ``jax.value_and_grad(loss_fn)`` for seven reduced
configs (falcon-mamba's through the scan's Function), in f32, with the
reference's ``init_params(PRNGKey(0))`` carried across (atol = rtol = 1e-4:
f32 on both sides, sums in other orders over a few layers); the chunked loss; ``remat="nothing_saveable"`` against
``"none"`` bit for bit; the kernels' autograd Functions, whose CPU path runs
the plain forward and the plain backward formula, against
``torch.autograd`` of the plain forward and ``jax.vjp`` of the reference's
plain versions (1e-5; the scan's in ``test_torch_scan_backward.py``);
``make_train_step`` against the reference's.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# every config on the kernel backend: deepseek-coder-33b's reduced head dim
# 8 too, which the flash wrapper takes (padded to 16 on the card)
LOSS_ARCHS = {"smollm-135m": "kernel", "qwen2-1.5b": "kernel", "olmo-1b": "kernel",
              "dbrx-132b": "kernel", "zamba2-7b": "kernel", "deepseek-coder-33b": "kernel",
              "falcon-mamba-7b": "kernel"}
B, S, ATOL = 2, 16, 1e-4


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    cfg = JCFG.get_reduced(arch)
    return jax.device_get(jax.jit(lambda key: JM.init_params(cfg, key))(jax.random.PRNGKey(0)))


def _batch(vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _port_only(arch, **overrides):
    """The reduced config and the port's own parameters (no JAX)."""
    tcfg = dataclasses.replace(TCFG.get_reduced(arch), **overrides)
    return tcfg, TM.init_params(tcfg, seed=0, device="cpu"), _batch(tcfg.vocab)


def _setup(arch, **overrides):
    jcfg = dataclasses.replace(JCFG.get_reduced(arch), **overrides)
    tcfg = dataclasses.replace(TCFG.get_reduced(arch), **overrides)
    jparams = _jax_tree(arch)
    tparams = params_from_numpy(jparams, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams, _batch(jcfg.vocab)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss_grads(jcfg, jparams, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b)))
    return fn(jparams, _jb(batch))


def _port_grads(tparams, tcfg, batch, backend):
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(tparams)]
    loss = TM.loss_fn(tree_unflatten(tparams, leaves), tcfg, _tb(batch), backend=backend)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, list(grads)


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, tparams, batch = _setup(arch)
    want, jgrads = _jax_loss_grads(jcfg, jparams, batch)
    got, grads = _port_grads(tparams, tcfg, batch, LOSS_ARCHS[arch])
    _close(got.detach(), want)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    if arch == "dbrx-132b":  # the aux loss is in the loss, and moves it
        logits, aux = TM.forward(tparams, tcfg, _tb(batch))
        assert float(aux) > 0


@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_every_leaf_gets_a_finite_grad(arch):
    tcfg, tparams, batch = _port_only(arch)
    _, grads = _port_grads(tparams, tcfg, batch, LOSS_ARCHS[arch])
    for g, p in zip(grads, tree_flatten(tparams)):
        assert g is not None and g.shape == p.shape and g.dtype == p.dtype
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("arch", ["smollm-135m", "dbrx-132b", "qwen2-1.5b"])
def test_chunked_loss_matches_jax_and_unchunked(arch):
    jcfg, tcfg, jparams, tparams, batch = _setup(arch, loss_chunk=4)
    want, jgrads = _jax_loss_grads(jcfg, jparams, batch)
    got, grads = _port_grads(tparams, tcfg, batch, "kernel")
    _close(got.detach(), want)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, w)
    plain, _ = _port_grads(tparams, dataclasses.replace(tcfg, loss_chunk=0), batch, "kernel")
    _close(got.detach(), plain.detach(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["smollm-135m", "dbrx-132b", "zamba2-7b", "olmo-1b",
                                  "falcon-mamba-7b", "qwen2-1.5b", "deepseek-coder-33b"])
def test_remat_is_bit_equal_to_none(arch):
    tcfg, tparams, batch = _port_only(arch)
    a_loss, a = _port_grads(tparams, dataclasses.replace(tcfg, remat="none"), batch, "kernel")
    b_loss, b = _port_grads(tparams, dataclasses.replace(tcfg, remat="nothing_saveable"),
                            batch, "kernel")
    assert torch.equal(a_loss, b_loss)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dots_saveable_names_the_roadmap():
    """``remat="dots_saveable"`` gives ``"nothing_saveable"``'s loss; a
    policy the reference lacks raises."""
    tcfg, tparams, batch = _port_only("smollm-135m", remat="dots_saveable")
    want = TM.loss_fn(tparams, dataclasses.replace(tcfg, remat="nothing_saveable"), _tb(batch))
    assert torch.equal(TM.loss_fn(tparams, tcfg, _tb(batch)), want)
    with pytest.raises(ValueError, match="unknown remat 'everything'"):
        TM.loss_fn(tparams, dataclasses.replace(tcfg, remat="everything"), _tb(batch))


def test_train_step_matches_jax():
    jcfg, tcfg, jparams, tparams, batch = _setup("smollm-135m")
    jopt_cfg, topt_cfg = JA.AdamWConfig(lr=1e-2, warmup_steps=2), TA.AdamWConfig(lr=1e-2,
                                                                                warmup_steps=2)
    jstep = jax.jit(JST.make_train_step(jcfg, jopt_cfg))
    tstep = TST.make_train_step(tcfg, topt_cfg)
    jopt, topt = JA.init_opt_state(jparams, jopt_cfg), TA.init_opt_state(tparams, topt_cfg)
    for _ in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, _jb(batch))
        before = [p.clone() for p in tree_flatten(tparams)]
        new, topt, tm = tstep(tparams, topt, _tb(batch))
        for p, q in zip(before, tree_flatten(tparams)):  # the given params are unchanged
            assert torch.equal(p, q)
        tparams = new
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], jm[k])
    for got, want in zip(tree_flatten(tparams), jax.tree_util.tree_leaves(jparams)):
        _close(got, want)
    assert int(topt["count"]) == int(jopt["count"]) == 3 and topt["count"].dtype == torch.int32


# -------------------------------------------------------------------- AdamW
def _tree(rng, state_dtype):
    """A random parameter tree of f32 and bf16 leaves, its grads and an
    AdamW state of ``state_dtype`` with non-zero moments (numpy, f32)."""
    shapes = {"a": ((5, 7), "float32"), "b": {"c": ((33,), "bfloat16"),
                                              "d": ((4, 3, 2), "float32")},
              "e": ((9, 4), "bfloat16")}

    def walk(node, fn):
        return ({k: walk(v, fn) for k, v in node.items()} if isinstance(node, dict)
                else fn(*node))

    params = walk(shapes, lambda s, dt: (rng.standard_normal(s), dt))
    grads = walk(shapes, lambda s, dt: (rng.standard_normal(s) * 0.3, dt))
    m = walk(shapes, lambda s, dt: (rng.standard_normal(s) * 0.01, state_dtype))
    v = walk(shapes, lambda s, dt: (np.abs(rng.standard_normal(s)) * 1e-3, state_dtype))
    return params, grads, m, v


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    arr, dt = tree
    return jnp.asarray(arr, jnp.float32).astype(jnp.dtype(dt))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr, dt = tree
    return torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dt))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clips", "no-clip"])
@pytest.mark.parametrize("count", [0, 49, 100, 5100, 20000],
                         ids=["step0", "mid-warmup", "warmup", "mid-decay", "past-decay"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype, count, clip):
    rng = np.random.default_rng(count + int(clip))
    params, grads, m, v = _tree(rng, state_dtype)
    jcfg = JA.AdamWConfig(grad_clip=clip, state_dtype=state_dtype)
    tcfg = TA.AdamWConfig(grad_clip=clip, state_dtype=state_dtype)
    jstate = {"m": _to_jax(m), "v": _to_jax(v), "count": jnp.asarray(count, jnp.int32)}
    tstate = {"m": _to_torch(m), "v": _to_torch(v), "count": torch.tensor(count,
                                                                          dtype=torch.int32)}
    jp, jo, jmet = jax.jit(lambda *a: JA.adamw_update(*a, jcfg))(_to_jax(params),
                                                                _to_jax(grads), jstate)
    tp, to, tmet = TA.adamw_update(_to_torch(params), _to_torch(grads), tstate, tcfg)
    assert (float(jmet["grad_norm"]) > clip) == (clip == 0.5)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-6, atol=0)
    for got, want in zip(tree_flatten((tp, to)), jax.tree_util.tree_leaves((jp, jo))):
        assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert int(to["count"]) == count + 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_donated_in_slices_keeps_the_bits(state_dtype, monkeypatch):
    """``donate=True`` writes the pure update's bits into the tensors it is
    given, and slices of 7 elements (a ragged last one; a transposed,
    non-contiguous grad) change none of them."""
    rng = np.random.default_rng(7)
    params, grads, m, v = _tree(rng, state_dtype)
    cfg = TA.AdamWConfig(grad_clip=0.5, state_dtype=state_dtype)
    state = lambda: {"m": _to_torch(m), "v": _to_torch(v), "count": torch.tensor(3)}
    tgrads = _to_torch(grads)
    tgrads["a"] = tgrads["a"].t().contiguous().t()
    assert not tgrads["a"].is_contiguous()
    want = TA.adamw_update(_to_torch(params), tgrads, state(), cfg)
    monkeypatch.setattr(TA, "_CHUNK", 7)
    given_p, given_s = _to_torch(params), state()
    ptrs = [t.data_ptr() for t in tree_flatten((given_p, given_s["m"], given_s["v"]))]
    got = TA.adamw_update(given_p, tgrads, given_s, cfg, donate=True)
    assert [t.data_ptr() for t in tree_flatten((got[0], got[1]["m"], got[1]["v"]))] == ptrs
    for a, b in zip(tree_flatten((got[0], got[1], got[2])), tree_flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    pure = TA.adamw_update(_to_torch(params), tgrads, state(), cfg)
    for a, b in zip(tree_flatten(pure), tree_flatten(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10100, 10101, 30000])
def test_lr_schedule_matches_jax(step):
    jcfg, tcfg = JA.AdamWConfig(), TA.AdamWConfig()
    want = JA.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
    got = TA.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


def test_init_opt_state_layout():
    """``{"count", "m", "v"}``: the leaves flatten in the reference's order."""
    _, tcfg, jparams, tparams, _ = _setup("smollm-135m")
    jo = JA.init_opt_state(jparams, JA.AdamWConfig(state_dtype="bfloat16"))
    to = TA.init_opt_state(tparams, TA.AdamWConfig(state_dtype="bfloat16"))
    jl, tl = jax.tree_util.tree_leaves((jparams, jo)), tree_flatten((tparams, to))
    assert [(x.shape, str(x.dtype)) for x in jl] == [(tuple(t.shape), str(t.dtype)[6:])
                                                     for t in tl]
    assert to["count"].shape == () and to["count"].dtype == torch.int32


# ------------------------------------------------- the kernels' Functions
def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (8, 4096): the backward kernel's rows of a group of 4 warps; (8, 7168): of 8
@pytest.mark.parametrize("rows,d", [(16, 48), (7, 100), (1, 576), (8, 4096), (8, 7168)])
def test_rmsnorm_backward_formula(rows, d):
    rng = np.random.default_rng(d)
    x, w, dy = _rand(rng, rows, d), _rand(rng, d) + 1.0, _rand(rng, rows, d)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = RK.rmsnorm(xt, wt)
    assert out.grad_fn is not None and "RMSNormFn" in type(out.grad_fn).__name__
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    # torch.autograd of the plain forward
    xa, wa = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    ax, aw = torch.autograd.grad(rmsnorm_ref(xa, wa), (xa, wa), torch.from_numpy(dy))
    _close(dx, ax, 1e-5, 1e-5)
    _close(dw, aw, 1e-5, 1e-5)
    # jax.vjp of the reference's plain version
    jx, jw = jax.jit(lambda a, b, g: jax.vjp(j_rmsnorm_ref, a, b)[1](g))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    _close(dx, jx, 1e-5, 1e-5)
    _close(dw, jw, 1e-5, 1e-5)
    bx, bw = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy))
    assert torch.equal(bx, dx) and torch.equal(bw, dw)


FLASH_CASES = [(2, 12, 6, 2, hd, 12, True) for hd in FK.HEAD_DIMS]
FLASH_CASES += [(1, 13, 3, 3, 16, 13, True),  # a group of 1, ragged S
                (2, 9, 3, 1, 32, 9, True),  # a group of 3
                (1, 10, 7, 1, 16, 10, True),  # a group of 7
                (2, 7, 4, 2, 16, 11, False),  # non-causal, T > S
                (1, 11, 6, 2, 32, 5, False),  # non-causal, T < S
                (1, 10, 12, 2, 128, 10, True),  # qwen2's group of 6
                (1, 9, 14, 2, 128, 9, True),  # deepseek's group of 7
                (2, 12, 6, 2, 8, 12, True),  # hd 8: no instance, padded on the card
                (1, 11, 4, 2, 48, 13, False)]  # hd 48, non-causal


@pytest.mark.parametrize("b,s,hq,hkv,hd,t,causal", FLASH_CASES)
def test_flash_backward_formula(b, s, hq, hkv, hd, t, causal):
    rng = np.random.default_rng(hd * 100 + s)
    q, k, v = _rand(rng, b, s, hq, hd), _rand(rng, b, t, hkv, hd), _rand(rng, b, t, hkv, hd)
    do = _rand(rng, b, s, hq, hd)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = FK.flash_attention(qt, kt, vt, causal=causal)
    assert out.grad_fn is not None and "FlashFn" in type(out.grad_fn).__name__
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    qa, ka, va = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    want = torch.autograd.grad(attention_ref(qa, ka, va, causal=causal), (qa, ka, va),
                               torch.from_numpy(do))
    for g, w in zip((dq, dk, dv), want):
        _close(g, w, 1e-5, 1e-5)
    jvjp = jax.jit(lambda a, b_, c, g: jax.vjp(
        lambda x, y, z: j_attention_ref(x, y, z, causal=causal), a, b_, c)[1](g))
    for g, w in zip((dq, dk, dv), jvjp(*(jnp.asarray(a) for a in (q, k, v, do)))):
        _close(g, w, 1e-5, 1e-5)
    # the forward with its log-sum-exp is the forward without it
    o2, lse = FK.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert torch.equal(o2, out.detach()) and lse.shape == (b, hq, s)
    _close(lse, attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal),
           1e-6, 1e-6)
    again = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), o2, lse,
                              torch.from_numpy(do), causal)
    for g, w in zip((dq, dk, dv), again):
        assert torch.equal(g, w)


def test_wrappers_without_grad_behave_as_before():
    """No grad required, or grad disabled: no Function, no graph; the
    outputs are the plain versions', as before the backward existed."""
    rng = np.random.default_rng(0)
    x, w = torch.from_numpy(_rand(rng, 4, 48)), torch.from_numpy(_rand(rng, 48) + 1)
    assert RK.rmsnorm(x, w).grad_fn is None and torch.equal(RK.rmsnorm(x, w), rmsnorm_ref(x, w))
    q, k, v = (torch.from_numpy(_rand(rng, 1, 8, 2, 16)) for _ in range(3))
    assert torch.equal(FK.flash_attention(q, k, v), attention_ref(q, k, v))
    with torch.no_grad():
        assert FK.flash_attention(q.requires_grad_(True), k, v).grad_fn is None
        assert RK.rmsnorm(x.requires_grad_(True), w).grad_fn is None


def test_backward_wrappers_check_their_arguments():
    rng = np.random.default_rng(0)
    x, w = torch.from_numpy(_rand(rng, 4, 48)), torch.from_numpy(_rand(rng, 48))
    with pytest.raises(TypeError):
        RK.rmsnorm_bwd(x, w, x.to(torch.bfloat16))
    q = torch.from_numpy(_rand(rng, 1, 8, 2, 16))
    o, lse = FK.flash_attention_lse(q, q, q)
    with pytest.raises(ValueError):
        FK.flash_attention_bwd(q, q, q, o, lse[:, :, :4], o)
