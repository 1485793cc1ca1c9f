"""The selective scan's fused mode (the mamba1 block's prefill: softplus,
scan and gate in one kernel) and its base mode, on the CPU.

On CPU tensors the wrapper runs the plain version (``ref.py``).  The fused
plain version must equal, bit for bit, the unfused sequence the block ran
before the fused mode (kept here as ``_unfused_block``); it must agree with
the JAX package's ``mamba1_block`` pieces (softplus, ``mamba1_scan``, the
D skip and the gate) to the block's tolerance, 1e-4 in f32 (a sequential
scan against an associative one); and the base mode must agree with the
JAX package's Pallas kernel in interpret mode at an S that is not a multiple
of the CUDA kernel's chunk of steps and at N < 16 (1e-4 in f32, 2e-2 in
bf16: one bf16 rounding of y on either side).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.mamba_scan.kernel import selective_scan as j_scan  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import selective_scan_op  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

F32, BF16 = "float32", "bfloat16"


def _fused_inputs(seed, b, s, di, n, dtype):
    """numpy inputs of the fused mode: dt_pre, dt_bias (every 7th channel
    past softplus's threshold of 20), A_log, B, C, x, z, D."""
    rng = np.random.default_rng(seed)
    bias = rng.uniform(-4.6, -1.0, di)
    bias[::7] = 21.0
    return {
        "dt_pre": rng.normal(0, 1.0, (b, s, di)), "dt_bias": bias,
        "a_log": rng.uniform(0, 0.5, (di, n)),
        "b": rng.normal(0, 0.5, (b, s, n)), "c": rng.normal(0, 0.5, (b, s, n)),
        "x": rng.normal(0, 0.5, (b, s, di)), "z": rng.normal(0, 1.0, (b, s, di)),
        "d": np.ones(di),
    }


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _fused_args(ins, dtype):
    """(args, kwargs) of the wrapper; z as the second half of an xz, as the
    block passes it."""
    x, z = _torch(ins["x"], dtype), _torch(ins["z"], dtype)
    xz = torch.cat([x, z], dim=-1)
    _, zh = xz.chunk(2, dim=-1)
    args = (_torch(ins["dt_pre"], dtype), _torch(ins["a_log"], F32), _torch(ins["b"], dtype),
            _torch(ins["c"], dtype), x, _torch(ins["d"], F32))
    return args, {"dt_bias": _torch(ins["dt_bias"], dtype), "z": zh}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,di,n", [(2, 40, 64, 16), (1, 1, 24, 5)])
def test_fused_plain_is_the_unfused_sequence_bit_for_bit(b, s, di, n, dtype):
    """The fused mode's plain version (and the wrapper on the CPU, through
    either backend of the op) equals softplus, the base scan on f32 dt and
    x, and the f32 gate run one after another."""
    args, kw = _fused_args(_fused_inputs(b + s + n, b, s, di, n, dtype), dtype)
    dt_pre, a_log, b_ssm, c_ssm, x, d_skip = args
    dt = F.softplus(dt_pre + kw["dt_bias"])
    y0, h0 = selective_scan_ref(dt.float(), a_log, b_ssm, c_ssm, x.float(), d_skip)
    want = (y0 * F.silu(kw["z"].float())).to(x.dtype)
    for got_y, got_h in (selective_scan_ref(*args, **kw), SK.selective_scan(*args, **kw),
                         selective_scan_op(*args, **kw, backend="ref")):
        assert got_y.dtype == x.dtype and got_h.dtype == torch.float32
        assert torch.equal(got_y, want) and torch.equal(got_h, h0)


def _cfg(dtype):
    return ModelConfig(name="m", family="ssm", n_layers=1, d_model=32, n_heads=1,
                       n_kv_heads=1, d_ff=0, vocab=64, ssm_version=1, ssm_state=8,
                       d_conv=4, expand=2, remat="none", dtype=dtype)


def _params(rng, cfg, dtype):
    d, di, n, dtr = cfg.d_model, cfg.d_inner(), cfg.ssm_state, cfg.dtr()
    shapes = {"in_proj": (d, 2 * di), "conv_w": (di, cfg.d_conv), "conv_b": (di,),
              "x_proj": (di, dtr + 2 * n), "dt_proj": (dtr, di), "dt_bias": (di,),
              "A_log": (di, n), "D_skip": (di,), "out_proj": (di, d)}
    p = {k: rng.normal(0, 0.2, v).astype(np.float32) for k, v in shapes.items()}
    p["dt_bias"] -= 3.0
    p["A_log"] = np.abs(p["A_log"])
    return {k: _torch(v, F32 if k in ("A_log", "D_skip") else dtype) for k, v in p.items()}


def _unfused_block(x, p, cfg):
    """The mamba1 block's prefill as it ran before the fused mode: softplus,
    f32 copies of dt and x, the base scan, then the f32 gate."""
    n = cfg.ssm_state
    xz = torch.matmul(x, p["in_proj"])
    xpart, z = xz.chunk(2, dim=-1)
    xpart, _ = TM._causal_conv(xpart, p["conv_w"], p["conv_b"])
    xpart = F.silu(xpart)
    proj = torch.matmul(xpart, p["x_proj"])
    dt_raw, b_ssm, c_ssm = torch.split(proj, [cfg.dtr(), n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_raw, p["dt_proj"]) + p["dt_bias"])
    y, h = selective_scan_ref(dt.float(), p["A_log"], b_ssm.contiguous(), c_ssm.contiguous(),
                              xpart.float(), p["D_skip"])
    y = (y * F.silu(z.float())).to(x.dtype)
    return torch.matmul(y, p["out_proj"]), h


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_mamba1_block_prefill_unchanged_bit_for_bit(dtype, backend):
    """The block's prefill through the fused mode gives the unfused
    sequence's output and final state, bit for bit, on either backend."""
    cfg = _cfg(dtype)
    rng = np.random.default_rng(15)
    p = _params(rng, cfg, dtype)
    x = _torch(rng.normal(0, 1.0, (2, 24, cfg.d_model)), dtype)
    want_out, want_h = _unfused_block(x, p, cfg)
    out, (h, _) = TM.mamba1_block(x, p, cfg, backend=backend)
    assert torch.equal(out, want_out) and torch.equal(h, want_h)


def _jax_fused(ins):
    """The JAX package's mamba1_block from dt_pre on: softplus of dt_pre +
    dt_bias, abar and bx, ``mamba1_scan``, y = C h + D x, the silu gate."""
    f32 = jnp.float32
    j = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in ins.items()}
    dt = jax.nn.softplus(j["dt_pre"] + j["dt_bias"])
    a = -jnp.exp(j["a_log"])
    abar = jnp.exp(dt[..., None] * a[None, None])
    bx = dt[..., None] * j["b"][:, :, None, :] * j["x"][..., None]
    hs = JM.mamba1_scan(abar, bx)
    y = jnp.einsum("bsdn,bsn->bsd", hs, j["c"]) + j["d"].astype(f32) * j["x"]
    return y * jax.nn.silu(j["z"]), hs[:, -1]


@pytest.mark.parametrize("b,s,di,n", [(2, 40, 64, 16), (1, 33, 32, 8)])
def test_fused_plain_matches_jax_mamba1_pieces(b, s, di, n):
    ins = _fused_inputs(di + s, b, s, di, n, F32)
    want_y, want_h = _jax_fused(ins)
    args, kw = _fused_args(ins, F32)
    y, h = SK.selective_scan(*args, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,s,di,n,chunk", [(2, 40, 64, 5, 8), (1, 72, 64, 8, 24)])
def test_base_mode_matches_pallas_at_ragged_s_and_small_n(b, s, di, n, chunk, dtype):
    """S = 40 and 72 are not multiples of the CUDA kernel's chunk (32 steps
    in bf16, 16 in f32); N = 5 and 8 leave states of the kernel's 16 idle."""
    rng = np.random.default_rng(s + n)
    dt = np.log1p(np.exp(rng.normal(0, 0.5, (b, s, di)) - 2))
    ins = [(dt, dtype), (rng.uniform(0, 0.5, (di, n)), F32),
           (rng.normal(0, 0.5, (b, s, n)), dtype), (rng.normal(0, 0.5, (b, s, n)), dtype),
           (rng.normal(0, 0.5, (b, s, di)), dtype), (np.ones(di), F32)]
    want = j_scan(*(jnp.asarray(np.asarray(a, np.float32)).astype(t) for a, t in ins),
                  blk_d=di, chunk=chunk, interpret=True)
    y, h = SK.selective_scan(*(_torch(a, t) for a, t in ins))
    assert y.dtype == getattr(torch, dtype) and h.shape == (b, di, n)
    tol = 1e-4 if dtype == F32 else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _bad(case):
    """The wrapper's fused-mode arguments with one fault."""
    args, kw = _fused_args(_fused_inputs(0, 2, 6, 16, 4, F32), F32)
    if case == "z_row_stride":  # rows that are not one stride apart
        kw["z"] = torch.randn(6, 2, 16).transpose(0, 1)
    elif case == "z_inner_stride":  # a row's elements not contiguous
        kw["z"] = torch.randn(2, 6, 32)[..., ::2]
    elif case == "dt_bias_dtype":
        kw["dt_bias"] = kw["dt_bias"].double()
    elif case == "dt_bias_shape":
        kw["dt_bias"] = kw["dt_bias"][:8].contiguous()
    elif case == "mode_mismatch_z":
        del kw["dt_bias"]
    elif case == "mode_mismatch_dt_bias":
        del kw["z"]
    elif case == "fused_bc_dtype":  # B and C in dt's dtype in the fused mode
        args = args[:2] + (args[2].bfloat16(), args[3].bfloat16()) + args[4:]
    return args, kw


@pytest.mark.parametrize("case,exc,match", [
    ("z_row_stride", ValueError, "z has strides"),
    ("z_inner_stride", ValueError, "z has strides"),
    ("dt_bias_dtype", TypeError, "dt_bias has dtype"),
    ("dt_bias_shape", ValueError, "dt_bias has shape"),
    ("mode_mismatch_z", ValueError, "mode mismatch"),
    ("mode_mismatch_dt_bias", ValueError, "mode mismatch"),
    ("fused_bc_dtype", TypeError, "b_ssm has dtype"),
])
def test_fused_mode_checks_its_arguments_on_the_cpu(case, exc, match):
    SK.reset_launches()
    args, kw = _bad(case)
    with pytest.raises(exc, match=match):
        SK.selective_scan(*args, **kw)
    assert SK.LAUNCHES == {"selective_scan": 0, "selective_scan_bwd": 0}


def test_z_row_strides_the_kernel_takes():
    """A contiguous z (row stride DI), the half of an xz (2 DI) and one row
    (S = 1) all pass the check and give the same result (to 1e-6: the CPU's
    silu takes another code path for a strided input)."""
    args, kw = _fused_args(_fused_inputs(3, 2, 6, 16, 4, F32), F32)
    assert SK._check_z(kw["z"], (2, 6, 16), torch.float32, torch.device("cpu")) == 32
    y_half, _ = SK.selective_scan(*args, **kw)
    y_cont, _ = SK.selective_scan(*args, **{**kw, "z": kw["z"].contiguous()})
    np.testing.assert_allclose(y_half.numpy(), y_cont.numpy(), atol=1e-6, rtol=1e-6)
    z1 = torch.randn(2, 1, 32)[..., 16:]
    assert SK._check_z(z1, (2, 1, 16), torch.float32, torch.device("cpu")) == 32
