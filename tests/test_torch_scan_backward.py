"""The selective scan's backward on the CPU: the plain backward
(``selective_scan_bwd_ref``) against ``torch.autograd`` of the plain forward
and against ``jax.vjp`` of the JAX package's jnp scan, in both modes, f32
at 1e-5 (f32 on both sides, sums in other orders over a few dozen steps);
the autograd Function's CPU path; the backward wrapper's argument checks;
and a reduced falcon-mamba trained through ``TrainRuntime``, crashed inside
its second checkpoint and resumed bit for bit.

The fused mode's JAX twin composes ``jax.nn.softplus``, the reference's
``selective_scan_ref`` and ``jax.nn.silu`` as the reference's
``mamba1_block`` composes them; where h_S's gradient is given, h_S is the
last state of the reference's ``mamba1_scan`` over the block's abar and bx.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan.ref import selective_scan_ref as j_scan  # noqa: E402
from repro.models.mamba import mamba1_scan as j_mamba1_scan  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TCK  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    selective_scan_bwd_ref,
    selective_scan_ref,
)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.train_loop import TrainRuntime  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
# (B, S, DI, N, the fused mode, z at row stride 2 DI (else contiguous), h_S's gradient)
CASES = [
    (2, 37, 70, 5, False, True, True),  # a ragged S, N < 16, DI not a multiple of 64
    (1, 20, 64, 16, False, True, False),
    (2, 37, 70, 5, True, True, True),  # z the half of an xz, at row stride 2 DI
    (1, 33, 24, 16, True, False, False),  # z contiguous
    (2, 16, 130, 3, True, True, False),
]


def _inputs(b, s, di, n, fused, seed):
    """numpy inputs: dt (base: positive; fused: dt_pre), A_log, B, C, x, D,
    dy, dh_last, and for the fused mode dt_bias (every 7th channel past
    softplus's threshold of 20) and z."""
    rng = np.random.default_rng(seed)
    ins = {"dt": (rng.normal(0, 1.0, (b, s, di)) if fused
                  else np.log1p(np.exp(rng.normal(-2.0, 1.0, (b, s, di))))),
           "a_log": rng.uniform(0, 0.5, (di, n)), "b": rng.normal(0, 0.5, (b, s, n)),
           "c": rng.normal(0, 0.5, (b, s, n)), "x": rng.normal(0, 0.5, (b, s, di)),
           "d": rng.uniform(0.5, 1.5, di), "dy": rng.normal(0, 0.5, (b, s, di)),
           "dh": rng.normal(0, 0.3, (b, di, n))}
    if fused:
        bias = rng.uniform(-4.6, -1.0, di)
        bias[::7] = 21.0
        ins.update(dt_bias=bias, z=rng.normal(0, 1.0, (b, s, di)))
    return {k: v.astype(np.float32) for k, v in ins.items()}


def _t(a):
    return torch.from_numpy(a)


def _port_args(ins, z_half):
    """(args, kwargs) of the port's scan; z as the second half of an xz (row
    stride 2 DI) or a tensor of its own."""
    args = tuple(_t(ins[k]) for k in ("dt", "a_log", "b", "c", "x", "d"))
    if "z" not in ins:
        return args, {}
    z = _t(ins["z"])
    if z_half:
        z = torch.cat([_t(ins["x"]), z], dim=-1)[..., z.shape[-1]:]
        assert z.stride(1) == 2 * z.shape[-1]
    return args, {"dt_bias": _t(ins["dt_bias"]), "z": z}


def _jax_fn(fused, with_h):
    """The reference's function of (dt, A_log, B, C, x, D[, dt_bias, z]) ->
    y (and h_S), in jnp."""
    def fn(dt, a_log, b, c, x, d, *rest):
        if fused:
            dt = jax.nn.softplus(dt + rest[0])
        y = j_scan(dt, a_log, b, c, x, d)
        if fused:
            y = y * jax.nn.silu(rest[1])
        if not with_h:
            return y
        a = -jnp.exp(a_log)
        abar = jnp.exp(dt[..., None] * a[None, None])
        bx = dt[..., None] * b[:, :, None, :] * x[..., None]
        return y, j_mamba1_scan(abar, bx)[:, -1]
    return fn


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,di,n,fused,z_half,with_dh", CASES)
def test_plain_backward_matches_autograd_and_jax(b, s, di, n, fused, z_half, with_dh):
    ins = _inputs(b, s, di, n, fused, seed=b * 1000 + s + di + n)
    args, kw = _port_args(ins, z_half)
    dy, dh = _t(ins["dy"]), _t(ins["dh"]) if with_dh else None
    got = selective_scan_bwd_ref(*args, dy, dh, **kw)
    names = ["dt", "a_log", "b", "c", "x", "d"] + (["dt_bias", "z"] if fused else [])
    assert [tuple(g.shape) for g in got] == [ins[k].shape for k in names]
    assert all(g.dtype == torch.float32 for g in got)
    if fused:
        assert got[7].is_contiguous()

    # torch.autograd of the plain forward
    leaves = [t.detach().clone().requires_grad_(True) for t in (*args, *kw.values())]
    y, h = selective_scan_ref(*leaves[:6], **dict(zip(kw, leaves[6:])))
    outs, grads = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
    want = torch.autograd.grad(outs, leaves, grads)
    for g, w in zip(got, want):
        _close(g, w)

    # jax.vjp of the reference's jnp scan (and softplus and silu, fused)
    jargs = [jnp.asarray(ins[k]) for k in names]
    cot = (jnp.asarray(ins["dy"]), jnp.asarray(ins["dh"])) if with_dh else jnp.asarray(ins["dy"])
    jgrads = jax.jit(lambda a, ct: jax.vjp(_jax_fn(fused, with_dh), *a)[1](ct))(jargs, cot)
    for g, w in zip(got, jgrads):
        _close(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["base", "fused"])
def test_scan_function_on_the_cpu(fused, dtype):
    """On the CPU the Function runs the plain forward (the same bits as the
    plain version) and the plain backward (the same bits as
    ``selective_scan_bwd_ref``), with h_S's gradient as its seed."""
    dt_ = getattr(torch, dtype)
    ins = _inputs(2, 37, 70, 5, fused, seed=7)
    args, kw = _port_args(ins, True)
    bc = dt_ if fused else torch.bfloat16
    args = (args[0].to(dt_), args[1], args[2].to(bc), args[3].to(bc), args[4].to(dt_), args[5])
    kw = {k: v.to(dt_) for k, v in kw.items()}
    dy, dh = _t(ins["dy"]).to(dt_), _t(ins["dh"])
    leaves = [t.detach().clone().requires_grad_(True) for t in (*args, *kw.values())]
    args, kw = tuple(t.detach() for t in leaves[:6]), {k: t.detach() for k, t in
                                                          zip(kw, leaves[6:])}
    y, h = SK.selective_scan(*leaves[:6], **dict(zip(kw, leaves[6:])))
    assert "ScanFn" in type(y.grad_fn).__name__
    want_y, want_h = selective_scan_ref(*args, **kw)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    got = torch.autograd.grad([y, h], leaves, [dy, dh])
    want = selective_scan_bwd_ref(*args, dy, dh, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # without h_S's gradient the seed is zero
    y, _ = SK.selective_scan(*leaves[:6], **dict(zip(kw, leaves[6:])))
    got = torch.autograd.grad(y, leaves, dy)
    for g, w in zip(got, selective_scan_bwd_ref(*args, dy, None, **kw)):
        assert torch.equal(g, w)


def test_scan_without_grad_has_no_function():
    ins = _inputs(1, 9, 24, 4, True, seed=3)
    args, kw = _port_args(ins, True)
    y, h = SK.selective_scan(*args, **kw)
    assert y.grad_fn is None and h.grad_fn is None
    assert torch.equal(y, selective_scan_ref(*args, **kw)[0])
    with torch.no_grad():
        y, _ = SK.selective_scan(args[0].clone().requires_grad_(True), *args[1:], **kw)
    assert y.grad_fn is None


def test_backward_wrapper_checks_its_arguments():
    ins = _inputs(1, 9, 24, 4, True, seed=4)
    args, kw = _port_args(ins, True)
    dy = _t(ins["dy"])
    with pytest.raises(TypeError):  # dy in another dtype than dt's
        SK.selective_scan_bwd(*args, dy.to(torch.bfloat16), **kw)
    with pytest.raises(ValueError):  # dy of another shape
        SK.selective_scan_bwd(*args, dy[:, :4], **kw)
    with pytest.raises(ValueError):  # dh_last of another shape
        SK.selective_scan_bwd(*args, dy, _t(ins["dh"])[:, :5], **kw)
    with pytest.raises(TypeError):  # dh_last not f32
        SK.selective_scan_bwd(*args, dy, _t(ins["dh"]).to(torch.bfloat16), **kw)
    with pytest.raises(ValueError):  # a strided dy
        SK.selective_scan_bwd(*args, torch.cat([dy, dy], -1)[..., 24:], **kw)
    with pytest.raises(ValueError):  # the fused mode's dt_bias without z
        SK.selective_scan_bwd(*args, dy, dt_bias=kw["dt_bias"])
    with pytest.raises(ValueError):  # chunk states of another shape (chunks of 16 in f32)
        SK.selective_scan_bwd(*args, dy, **kw, chunk_states=torch.zeros(1, 2, 24, 4))
    assert SK.chunk_steps(torch.float32) == 16 and SK.chunk_steps(torch.bfloat16) == 32
    ok = SK.selective_scan_bwd(*args, dy, **kw, chunk_states=torch.zeros(1, 1, 24, 4))
    assert all(torch.equal(a, b) for a, b in zip(ok, selective_scan_bwd_ref(*args, dy, **kw)))
    with pytest.raises(ValueError):  # the chunk states come from the card's kernel
        SK.selective_scan_states(*args, **kw)


@pytest.mark.parametrize("b,s,di,n", [(8, 2048, 8192, 16), (2, 33, 200, 5), (1, 1, 1, 1)])
def test_backward_scratch_follows_the_kernel_layout(b, s, di, n):
    """``bwd_scratch`` against the layout it documents: per block of
    ``BLOCK_CHANNELS`` channels (the source's kBwdCh) a partial of dB and of
    dC, (blocks, B, S, N) each; per batch row d a (DI, N), dD and
    d dt_bias (DI each)."""
    src = (SK._HERE / "csrc" / "selective_scan.cu").read_text()
    assert f"constexpr int kBwdCh = {SK.BLOCK_CHANNELS};" in src
    blocks = -(-di // 128)
    assert SK.BLOCK_CHANNELS == 128
    assert SK.bwd_scratch(b, s, di, n) == (2 * blocks * b * s * n, b * di * n + 2 * b * di)


def test_backward_checks_under_the_block_layout():
    """The wrapper's checks at a DI off the 128-channel block and an S
    ragged against both the 32-step chunk and the 4-step sub-chunk (bf16:
    two chunks of states), and its CPU path equal to the plain backward."""
    bf = torch.bfloat16
    ins = _inputs(1, 33, 130, 4, True, seed=6)
    (dt, a_log, bm, cm, x, d), kw = _port_args(ins, False)
    args = (dt.to(bf), a_log, bm.to(bf), cm.to(bf), x.to(bf), d)
    kw = {k: v.to(bf) for k, v in kw.items()}
    dy = _t(ins["dy"]).to(bf)
    assert SK.chunk_steps(torch.bfloat16) == 32
    for chunks in (1, 3):  # ceil(33 / 32) = 2 chunks
        with pytest.raises(ValueError):
            SK.selective_scan_bwd(*args, dy, **kw, chunk_states=torch.zeros(1, chunks, 130, 4))
    with pytest.raises(TypeError):  # bf16 chunk states
        SK.selective_scan_bwd(*args, dy, **kw,
                              chunk_states=torch.zeros(1, 2, 130, 4, dtype=torch.bfloat16))
    ok = SK.selective_scan_bwd(*args, dy, **kw, chunk_states=torch.zeros(1, 2, 130, 4))
    assert all(torch.equal(a, b) for a, b in zip(ok, selective_scan_bwd_ref(*args, dy, **kw)))


def _falcon_runtime(root, injector=None):
    cfg = get_reduced("falcon-mamba-7b")
    return TrainRuntime(cfg, AdamWConfig(lr=1e-3), DataPipeline(vocab=cfg.vocab, batch_size=2,
                                                               seq_len=8, seed=3),
                        TCK.SimFS(root, injector), n_workers=2, ckpt_every=2, device="cpu")


def test_falcon_resume_equals_uninterrupted(tmp_path):
    """The reduced falcon-mamba through ``TrainRuntime``: a crash inside the
    second combine, a boot on the durable view, and the finished run's
    losses, params and AdamW state bit-equal to the uninterrupted run's."""
    ref = _falcon_runtime(tmp_path / "ref")
    p_ref, o_ref, losses = ref.train(6)
    per_ckpt = (ref.fs.stats["pwb"] + ref.fs.stats["pfence"]) // 3
    rt = _falcon_runtime(tmp_path / "crash", TCK.FaultInjector(crash_at=per_ckpt + 20))
    with pytest.raises(TCK.CrashNow):
        rt.train(6)
    rt2 = _falcon_runtime(tmp_path / "crash")
    _, _, step, cursor, report = rt2.boot()
    assert step == cursor == 2
    assert all(r == {"committed": False, "step": 4} for r in report.values())
    p2, o2, losses2 = rt2.train(6)
    assert losses2 == losses[2:]
    for a, b in zip(tree_flatten((p_ref, o_ref)), tree_flatten((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
