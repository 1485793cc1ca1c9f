"""The port's models against the JAX package's, on the CPU.

The reduced ``smollm-135m``, ``qwen2-1.5b`` (QKV bias, tied embeddings),
``olmo-1b`` (non-parametric LayerNorm, an untied ``lm_head``) (dense) and
``falcon-mamba-7b`` (ssm) configs in f32, with the JAX package's ``init_params(PRNGKey(0))`` carried across
by ``params_from_numpy``: forward logits, prefill's last logits and cache,
eight decode steps and the greedy tokens must match the reference (logits
to 1e-4: f32 on both sides, products summed in different orders over a few
layers).  The port's own prefill-then-decode must reproduce its forward, as
``tests/test_models.py`` checks the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["smollm-135m", "qwen2-1.5b", "olmo-1b", "falcon-mamba-7b"]
B, S, MAX_LEN, ATOL = 2, 12, 24, 1e-4


def _setup(arch):
    jcfg = JCFG.get_reduced(arch)
    tcfg = TCFG.get_reduced(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, jparams, tparams, tokens


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _jt(tokens):
    return {"tokens": jnp.asarray(tokens, jnp.int32)}


def _tt(tokens):
    return {"tokens": torch.from_numpy(np.asarray(tokens))}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The copied configs carry the reference's values in every field the
    port keeps, and the same parameter counts."""
    for getter in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (getter, f.name)
        assert (tcfg.hd(), tcfg.d_inner(), tcfg.dtr(), tcfg.param_count()) == (
            jcfg.hd(), jcfg.d_inner(), jcfg.dtr(), jcfg.param_count())
        assert tcfg.act_dtype() == getattr(torch, jcfg.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    want, _ = JM.forward(jparams, jcfg, _jt(tokens))
    got, aux = TM.forward(tparams, tcfg, _tt(tokens))
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 4 tokens, then 8 teacher-forced decode steps: last logits,
    caches and per-step logits as the reference's."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    half = 4
    jlast, jcache = JM.prefill(jparams, jcfg, _jt(tokens[:, :half]), MAX_LEN)
    tlast, tcache = TM.prefill(tparams, tcfg, _tt(tokens[:, :half]), MAX_LEN)
    _close(tlast, jlast)
    assert tcache["len"] == int(jcache["len"]) == half
    for name in ("k", "v") if tcfg.family == "dense" else ("ssm", "conv"):
        _close(tcache[name], jcache[name])
    jdec = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b))
    for i in range(half, half + 8):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]))
        _close(tl, jl)
    assert tcache["len"] == int(jcache["len"]) == half + 8


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    """The steps of both packages decode the same greedy tokens."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    jpre = jax.jit(JST.make_prefill_step(jcfg, MAX_LEN))
    jserve = jax.jit(JST.make_serve_step(jcfg))
    last, cache = jpre(jparams, _jt(tokens[:, :6]))
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok[:, 0])]
    for _ in range(8):
        out, cache = jserve(jparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    last, cache = TST.make_prefill_step(tcfg, MAX_LEN)(tparams, _tt(tokens[:, :6]))
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    got = [tok[:, 0].numpy()]
    out, cache = TST.make_quantum_step(tcfg, quantum=8)(tparams, cache, tok)
    got += [out["tokens"][:, i].numpy() for i in range(8)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert torch.equal(out["next_token"], out["tokens"][:, -1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port on its own: prefill of half the sequence, then decode one
    token at a time, reproduces the full forward (the reference's
    ``tests/test_models.py`` check, at its tolerance)."""
    _, tcfg, _, tparams, tokens = _setup(arch)
    ref, _ = TM.forward(tparams, tcfg, _tt(tokens))
    half = S // 2
    last, cache = TM.prefill(tparams, tcfg, _tt(tokens[:, :half]), S + 4)
    _close(last[:, 0], ref[:, half - 1], 2e-3)
    serve = TST.make_serve_step(tcfg)
    for i in range(half, S):
        out, cache = serve(tparams, cache, _tt(tokens[:, i:i + 1]))
        _close(out["logits"][:, 0], ref[:, i], 2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_and_ref_backends_agree_on_cpu(arch):
    """On CPU tensors the kernel backend runs the plain versions, so the two
    backends compute the same thing."""
    _, tcfg, _, tparams, tokens = _setup(arch)
    a, _ = TM.forward(tparams, tcfg, _tt(tokens), backend="kernel")
    b, _ = TM.forward(tparams, tcfg, _tt(tokens), backend="ref")
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_spec(arch):
    jcfg, tcfg, jparams, tparams, _ = _setup(arch)
    tree = jax.device_get(jparams)
    back = params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b, np.float32))
    # the port's own init: the reference's names, shapes and dtypes
    own = TM.init_params(tcfg, seed=0, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(own)),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    first = TM.init_params(tcfg, seed=0, device="cpu")["embed"]
    assert torch.equal(own["embed"], first)
    bad = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="names"):
        params_from_numpy(bad, tcfg, "cpu")
    bad = dict(tree, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, tcfg, "cpu")


def test_qkv_bias_matches_jax():
    """qwen2's QKV bias with non-zero values (the reference initialises it to
    zeros, which would hide a bias added in the wrong place): forward, and
    prefill then decode, as the reference's."""
    jcfg, tcfg, jparams, _, tokens = _setup("qwen2-1.5b")
    rng = np.random.default_rng(5)
    attn = dict(jparams["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(0, 0.5, attn[name].shape), jnp.float32)
    jparams = dict(jparams, blocks=dict(jparams["blocks"], attn=attn))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    want, _ = JM.forward(jparams, jcfg, _jt(tokens))
    got, _ = TM.forward(tparams, tcfg, _tt(tokens))
    _close(got, want)
    jlast, jcache = JM.prefill(jparams, jcfg, _jt(tokens[:, :4]), MAX_LEN)
    tlast, tcache = TM.prefill(tparams, tcfg, _tt(tokens[:, :4]), MAX_LEN)
    _close(tlast, jlast)
    for i in range(4, 8):
        jl, jcache = JM.decode_step(jparams, jcfg, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]))
        _close(tl, jl)


def test_param_trees_of_the_new_dense_configs():
    """The QKV-bias leaves and the empty norm leaves sit where the
    reference's ``_attn_params`` and ``_norm_scale`` put them, and olmo
    keeps an untied ``lm_head``."""
    shapes = {}
    for arch in ("qwen2-1.5b", "olmo-1b"):
        jcfg, tcfg = JCFG.get_reduced(arch), TCFG.get_reduced(arch)
        tree = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
        flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(
            TM.param_spec(tcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
        shapes[arch] = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
        assert {jax.tree_util.keystr(k): tuple(v[0]) for k, v in flat_t} == shapes[arch]
    ocfg, olmo = TCFG.get_reduced("olmo-1b"), shapes["olmo-1b"]
    assert olmo["['final_norm']"] == (0,) and olmo["['blocks']['norm1']"] == (ocfg.n_layers, 0)
    assert olmo["['lm_head']"] == (ocfg.d_model, ocfg.vocab)
    qcfg = TCFG.get_reduced("qwen2-1.5b")
    attn = TM.param_spec(qcfg)["blocks"]["attn"]
    hd = qcfg.hd()
    assert [attn[n][0] for n in ("bq", "bk", "bv")] == [
        (qcfg.n_layers, qcfg.n_heads * hd), (qcfg.n_layers, qcfg.n_kv_heads * hd),
        (qcfg.n_layers, qcfg.n_kv_heads * hd)]
    assert "lm_head" not in TM.param_spec(qcfg)


def test_bf16_leaves_cross_bit_for_bit():
    """A bf16 tree (the published configs' dtype) crosses with its bits."""
    jcfg = dataclasses.replace(JCFG.get_reduced("smollm-135m"), dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG.get_reduced("smollm-135m"), dtype="bfloat16")
    tree = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(tree["embed"], np.float32))


@pytest.mark.parametrize("family", ["moe", "vlm", "hybrid", "audio"])
def test_unported_families_raise(family):
    """Every family of the reference is ported now: the moe, audio, vlm and
    hybrid families build their params and caches (``tests/test_torch_
    model_families.py``, ``tests/test_torch_moe.py`` and ``tests/test_torch_
    hybrid.py`` hold them against JAX); an unknown family raises."""
    extra = {"vlm": dict(cross_attn_every=2, n_img_tokens=4),
             "audio": dict(embedding_inputs=True, mlp="gelu"),
             "moe": dict(n_experts=4, top_k=2, moe_dff=48),
             "hybrid": dict(ssm_version=2, ssm_state=8, ssm_head_dim=16, attn_every=1)
             }.get(family, {})
    cfg = ModelConfig(name="x", family=family, n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=64, dtype="float32", **extra)
    assert family in TM.FAMILIES
    params = TM.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    if family == "moe":
        assert params["blocks"]["moe"]["w1"].shape == (2, 4, 32, 48)
        assert "mlp" not in params["blocks"]
    elif family == "hybrid":  # two groups of one mamba2 layer, one shared block, no tail
        assert params["mamba_groups"]["mamba"]["in_proj"].shape == (2, 1, 32, 2 * 64 + 16 + 4)
        assert "mamba_tail" not in params and "wq" in params["shared_attn"]["attn"]
        assert cache["ssm"].shape == (2, 1, 1, 4, 16, 8) and "tail_ssm" not in cache
    else:
        assert "embed" not in params if family == "audio" else "self_blocks" in params
    kv = cache["attn_k"] if family == "hybrid" else cache["k"]
    assert kv.shape[-3:] == (8, 2, 8) and cache["len"] == 0
    with pytest.raises(ValueError, match="nope"):
        TM.init_params(dataclasses.replace(cfg, family="nope"), device="cpu")


def test_cross_attention_raises():
    """Cross-attention runs the flash kernel's non-causal mode: on the
    kernel backend a head dim past the kernel's widest instance (160 here)
    raises, on the CPU as on the card, and the plain backend computes it; a
    head dim without an instance of its own (8, padded on the card) runs,
    on the CPU as the plain backend's."""
    def block(hd):
        d = 4 * hd
        cfg = ModelConfig(name="x", family="vlm", n_layers=5, d_model=d, n_heads=4,
                          n_kv_heads=2, d_ff=64, vocab=64, cross_attn_every=5,
                          dtype="float32")
        g = torch.Generator().manual_seed(0)
        p = {n: torch.randn(d, w, generator=g) * 0.2
             for n, w in (("wq", d), ("wk", d // 2), ("wv", d // 2), ("wo", d))}
        x, src = torch.randn(1, 2, d, generator=g), torch.randn(1, 5, d, generator=g)
        return lambda **kw: L.attention_block(x, p, cfg, torch.arange(2), kv_override=src,
                                              **kw)

    wide, narrow = block(160), block(8)
    with pytest.raises(ValueError, match="head dim 160"):
        wide()
    out, cache = wide(backend="ref")
    assert out.shape == (1, 2, 640) and cache is None and bool(torch.isfinite(out).all())
    out, cache = narrow()
    assert out.shape == (1, 2, 32) and cache is None
    assert torch.equal(out, narrow(backend="ref")[0])


def test_gqa_attention_matches_jax_with_offset():
    """Decode attention: one query at position ``q_offset`` against a cache
    whose tail past it is masked."""
    rng = np.random.default_rng(4)
    q = rng.normal(0, 0.5, (2, 1, 6, 16)).astype(np.float32)
    k = rng.normal(0, 0.5, (2, 10, 2, 16)).astype(np.float32)
    v = rng.normal(0, 0.5, (2, 10, 2, 16)).astype(np.float32)
    want = JL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=6)
    got = L.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=6)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_is_trunk_then_logits(arch):
    """``forward`` is ``_trunk`` then ``_logits``, bit for bit, under remat
    or not; with grad disabled no Function runs and no graph is built, and
    under autograd the output is the same bits."""
    _, tcfg, _, tparams, tokens = _setup(arch)
    batch = _tt(tokens)
    with torch.no_grad():
        h, aux = TM._trunk(tparams, tcfg, batch)
        want = TM._logits(tparams, tcfg, h)
        for remat in ("none", "nothing_saveable"):
            got, got_aux = TM.forward(tparams, dataclasses.replace(tcfg, remat=remat), batch)
            assert got.grad_fn is None and torch.equal(got, want) and torch.equal(got_aux, aux)
    live = {k: v for k, v in tparams.items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(live)]
    got, _ = TM.forward(tree_unflatten(live, leaves), tcfg, batch)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)
