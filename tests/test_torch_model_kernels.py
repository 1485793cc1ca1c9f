"""The model kernels' plain versions against the JAX package's Pallas
kernels (interpret mode), on the CPU.

Each wrapper of the port, given CPU tensors, runs its plain version
(``ref.py``); the same inputs, made from a seed with numpy, go through the
JAX package's Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
shapes.  Tolerances: f32 1e-5 (absolute and relative; both sides sum in f32
in different orders), the scan 1e-4 (a sequential loop against the TPU
kernel's chunked loop and the model's associative scan), bf16 2e-2 (one
bf16 rounding of the output, about 8e-3 relative, on either side).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.mamba_scan.kernel import selective_scan as j_scan  # noqa: E402
from repro.kernels.rmsnorm.kernel import rmsnorm as j_rmsnorm  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import selective_scan_op  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 1e-5, BF16: 2e-2}


def _pair(a, dtype):
    """One numpy array as a jax and a torch array of ``dtype`` (both round
    f32 to bf16 to nearest even, so they hold the same values)."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a.copy()).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("r,d,blk", [(256, 512, 128), (64, 64, 64)])
def test_rmsnorm_matches_pallas(r, d, blk, dtype):
    rng = np.random.default_rng(r + d)
    jx, tx = _pair(rng.normal(0, 0.5, (r, d)), dtype)
    jw, tw = _pair(rng.normal(0, 0.5, (d,)) + 1.0, F32)
    want = j_rmsnorm(jx, jw, blk=blk, interpret=True)
    got = RK.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype])
    # the op over a leading shape, on either backend
    for backend in ("kernel", "ref"):
        _close(rmsnorm_op(tx.reshape(2, r // 2, d), tw, backend=backend).reshape(r, d),
               want, TOL[dtype])


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,hq,hkv,hd,blk,causal", [
    (1, 128, 2, 2, 64, 64, True),   # group 1
    (2, 128, 3, 1, 64, 64, True),   # group 3, odd head count
    (1, 128, 2, 2, 32, 64, False),  # full attention
])
def test_flash_attention_matches_pallas(b, s, hq, hkv, hd, blk, causal, dtype):
    rng = np.random.default_rng(s + hq + hd)
    jq, tq = _pair(rng.normal(0, 0.5, (b, s, hq, hd)), dtype)
    jk, tk = _pair(rng.normal(0, 0.5, (b, s, hkv, hd)), dtype)
    jv, tv = _pair(rng.normal(0, 0.5, (b, s, hkv, hd)), dtype)
    want = j_flash(jq, jk, jv, causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    got = FK.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])
    _close(attention(tq, tk, tv, causal=causal, backend="ref"), want, TOL[dtype])


@pytest.mark.parametrize("s", [100, 200])
def test_flash_attention_ragged_length_matches_attention_ref(s):
    """S not a multiple of any tile: every row is computed (the Pallas
    kernel would drop the rows past s // blk_q * blk_q)."""
    rng = np.random.default_rng(s)
    jq, tq = _pair(rng.normal(0, 0.5, (2, s, 9, 16)), F32)
    jk, tk = _pair(rng.normal(0, 0.5, (2, s, 3, 16)), F32)
    jv, tv = _pair(rng.normal(0, 0.5, (2, s, 3, 16)), F32)
    want = j_attention_ref(jq, jk, jv, causal=True)
    _close(FK.flash_attention(tq, tk, tv), want, TOL[F32])


def test_bf16_weights_in_pv_fit_the_chip_gate():
    """The bf16 kernel rounds the softmax weights P to bf16 for the P V
    product (at most 2^-8 relative per weight: bf16 keeps 8 significant
    bits; the denominator sums the unrounded weights).  That attention,
    computed here in f32 from the same bf16 inputs, stays within half of the
    bf16 gate chip_smoke.py holds the kernel to (atol = rtol = 1e-2) of the
    JAX package's Pallas kernel."""
    b, s, hq, hkv, hd = 1, 256, 9, 3, 64
    rng = np.random.default_rng(14)
    jq, tq = _pair(rng.normal(0, 0.5, (b, s, hq, hd)), BF16)
    jk, tk = _pair(rng.normal(0, 0.5, (b, s, hkv, hd)), BF16)
    jv, tv = _pair(rng.normal(0, 0.5, (b, s, hkv, hd)), BF16)
    want = j_flash(jq, jk, jv, causal=True, blk_q=128, blk_k=128, interpret=True)
    g = hq // hkv
    qf = tq.float().reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, tk.float()) / np.sqrt(hd)
    scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p_bf16 = p.to(torch.bfloat16).float()
    assert float(((p_bf16 - p).abs() / p.clamp_min(1e-30)).max()) <= 2.0 ** -8
    out = torch.einsum("bkgst,btkd->bskgd", p_bf16, tv.float()) / p.sum(-1)[..., None].permute(
        0, 3, 1, 2, 4)
    got = out.reshape(b, s, hq, hd).to(torch.bfloat16).float().numpy()
    ref = _np(want)
    tol = 1e-2  # chip_smoke.py's bf16 gate
    used = np.abs(got - ref) / (tol + tol * np.abs(ref))
    assert used.max() < 0.5, f"the worst element uses {used.max():.3f} of the gate"


# ------------------------------------------------------------ selective scan
def _scan_inputs(rng, b, s, di, n, dtype):
    dt = np.log1p(np.exp(rng.normal(0, 0.5, (b, s, di)) - 2))  # softplus
    return (
        _pair(dt, dtype),
        _pair(rng.uniform(0, 0.5, (di, n)), F32),
        _pair(rng.normal(0, 0.5, (b, s, n)), dtype),
        _pair(rng.normal(0, 0.5, (b, s, n)), dtype),
        _pair(rng.normal(0, 0.5, (b, s, di)), dtype),
        _pair(np.ones(di), F32),
    )


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,di,n,blk_d,chunk", [(2, 64, 128, 8, 64, 32),
                                                  (1, 128, 64, 16, 64, 64)])
def test_selective_scan_matches_pallas(b, s, di, n, blk_d, chunk, dtype):
    ins = _scan_inputs(np.random.default_rng(di + s), b, s, di, n, dtype)
    want = j_scan(*(j for j, _ in ins), blk_d=blk_d, chunk=chunk, interpret=True)
    y, h = SK.selective_scan(*(t for _, t in ins))
    assert y.dtype == ins[0][1].dtype and h.shape == (b, di, n) and h.dtype == torch.float32
    _close(y, want, 1e-4 if dtype == F32 else TOL[BF16])
    y2, h2 = selective_scan_op(*(t for _, t in ins), backend="ref")
    assert torch.equal(y2, y) and torch.equal(h2, h)


def _mamba_cfg():
    return JConfig(name="m", family="ssm", n_layers=1, d_model=32, n_heads=1,
                   n_kv_heads=1, d_ff=0, vocab=64, ssm_version=1, ssm_state=8,
                   d_conv=4, expand=2, remat="none", dtype="float32")


def _mamba_params(rng, cfg):
    d, di, n, dtr = cfg.d_model, cfg.d_inner(), cfg.ssm_state, cfg.dtr()
    shapes = {"in_proj": (d, 2 * di), "conv_w": (di, cfg.d_conv), "conv_b": (di,),
              "x_proj": (di, dtr + 2 * n), "dt_proj": (dtr, di), "dt_bias": (di,),
              "A_log": (di, n), "D_skip": (di,), "out_proj": (di, d)}
    p = {k: rng.normal(0, 0.2, v).astype(np.float32) for k, v in shapes.items()}
    p["dt_bias"] -= 3.0
    p["A_log"] = np.abs(p["A_log"])
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_scan_final_state_matches_mamba1_block():
    """The scan's final state is the JAX block's ``new_h`` (its associative
    scan's last step), and the block's output and conv tail agree."""
    cfg = _mamba_cfg()
    tcfg = ModelConfig(**{f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__})
    rng = np.random.default_rng(5)
    jp, tp = _mamba_params(rng, cfg)
    jx, tx = _pair(rng.normal(0, 1.0, (2, 24, cfg.d_model)), F32)
    jout, (jh, jtail) = JM.mamba1_block(jx, jp, cfg)
    tout, (th, ttail) = TM.mamba1_block(tx, tp, tcfg)
    _close(th, jh, 1e-4)
    _close(tout, jout, 1e-4)
    _close(ttail, jtail, 0)
    # one decode step from that state, plain on both sides
    jx1, tx1 = _pair(rng.normal(0, 1.0, (2, 1, cfg.d_model)), F32)
    jout1, (jh1, _) = JM.mamba1_block(jx1, jp, cfg, state=(jh, jtail))
    tout1, (th1, _) = TM.mamba1_block(tx1, tp, tcfg, state=(th, ttail))
    _close(th1, jh1, 1e-4)
    _close(tout1, jout1, 1e-4)


def test_mamba1_scan_matches_associative_scan():
    rng = np.random.default_rng(9)
    ja, ta = _pair(rng.uniform(0.5, 1.0, (2, 16, 8, 4)), F32)
    jb, tb = _pair(rng.normal(0, 1.0, (2, 16, 8, 4)), F32)
    _close(TM.mamba1_scan(ta, tb), JM.mamba1_scan(ja, jb), 1e-5)


# ------------------------------------------------------------------ wrappers
def test_cpu_calls_launch_nothing_and_check_like_the_kernels():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted, nothing is built.  They check their arguments as for the card,
    and the ops reject an unknown backend."""
    for mod in (RK, FK, SK):
        mod.reset_launches()
    x = torch.randn(4, 16)
    RK.rmsnorm(x, torch.ones(16))
    q = torch.randn(1, 8, 2, 16)
    kv = q[:, :, :1].contiguous()
    FK.flash_attention(q, kv, kv)
    SK.selective_scan(torch.rand(1, 4, 8), torch.rand(8, 2), torch.randn(1, 4, 2),
                      torch.randn(1, 4, 2), torch.randn(1, 4, 8), torch.ones(8))
    # and the backward (the autograd Functions' CPU path)
    xg = x.clone().requires_grad_(True)
    RK.rmsnorm(xg, torch.ones(16)).sum().backward()
    qg = q.clone().requires_grad_(True)
    FK.flash_attention(qg, kv, kv).sum().backward()
    dtg = torch.rand(1, 4, 8).requires_grad_(True)
    SK.selective_scan(dtg, torch.rand(8, 2), torch.randn(1, 4, 2), torch.randn(1, 4, 2),
                      torch.randn(1, 4, 8), torch.ones(8))[0].sum().backward()
    assert xg.grad is not None and qg.grad is not None and dtg.grad is not None
    assert RK.LAUNCHES == {"rmsnorm": 0, "rmsnorm_bwd": 0}
    assert FK.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert SK.LAUNCHES == {"selective_scan": 0, "selective_scan_bwd": 0}
    # the CPU path takes only what the kernel takes: a strided view, a
    # dtype or a head width past the kernel's widest instance; a width
    # between its instances (24, padded to 32 on the card) runs
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="contiguous"):
        RK.rmsnorm(x.t(), torch.ones(4))
    with pytest.raises(TypeError):
        RK.rmsnorm(x.double(), torch.ones(16))
    with pytest.raises(ValueError, match="head dim 136"):
        FK.flash_attention(*([torch.randn(1, 4, 1, 136)] * 3))
    odd = np.random.default_rng(24).standard_normal((1, 4, 1, 24)).astype(np.float32)
    np.testing.assert_allclose(FK.flash_attention(*[torch.from_numpy(odd)] * 3).numpy(),
                               np.asarray(j_attention_ref(*[jnp.asarray(odd)] * 3, causal=True)),
                               atol=1e-5, rtol=1e-5)
    # every check of the one-pass argument check, on each argument after
    # the first: device, dtype, shape, layout
    meta = torch.empty(kv.shape, device="meta")
    with pytest.raises(ValueError, match="k is on meta"):
        FK.flash_attention(q, meta, kv)
    with pytest.raises(TypeError, match="v has dtype"):
        FK.flash_attention(q, kv, kv.bfloat16())
    with pytest.raises(ValueError, match="v has shape"):
        FK.flash_attention(q, kv, kv[:, :4].contiguous())
    with pytest.raises(ValueError, match="v must be contiguous"):
        FK.flash_attention(q, kv, torch.randn(1, 8, 2, 16)[:, :, :1])
    with pytest.raises(ValueError, match="w is on meta"):
        RK.rmsnorm(x, torch.ones(16, device="meta"))
    with pytest.raises(TypeError, match="w has dtype"):
        RK.rmsnorm(x, torch.ones(16, dtype=torch.float64))
    with pytest.raises(ValueError, match="w has shape"):
        RK.rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="w must be contiguous"):
        RK.rmsnorm(x, torch.ones(32)[::2])
    with pytest.raises(ValueError, match="state size"):
        SK.selective_scan(torch.rand(1, 4, 8), torch.rand(8, 17), torch.randn(1, 4, 17),
                          torch.randn(1, 4, 17), torch.randn(1, 4, 8), torch.ones(8))
    with pytest.raises(ValueError):
        rmsnorm_op(x, torch.ones(16), backend="pallas")
    with pytest.raises(ValueError):
        attention(q, q, q, backend="chunked")
    with pytest.raises(ValueError):
        selective_scan_op(*([x] * 6), backend="pallas")


def test_libraries_build_under_build_with_a_source_hash():
    """Each model kernel is its own library under ``build/<group>/``, keyed
    by a hash of its source, the shared header and the flags (nothing is
    compiled here: there is no nvcc)."""
    libs = RK.LIBRARIES + FK.LIBRARIES + SK.LIBRARIES
    paths = [lib.path() for lib in libs]
    assert [p.parent.parent.name for p in paths] == ["rmsnorm", "flash_attention", "mamba_scan"]
    assert all(p.parent.parent.parent == nvcc.BUILD_ROOT for p in paths)
    assert all(nvcc.MODEL_COMMON in lib.headers and lib.source.exists() for lib in libs)
    assert len({p.parent.name for p in paths}) == 3
