"""The port's audio and vlm families and ``deepseek-coder-33b`` against the
JAX package's, on the CPU.

The reduced ``deepseek-coder-33b`` (dense, a query group of 7),
``musicgen-large`` (audio: frame embeddings in, gelu MLP, an untied
``lm_head``) and ``llama-3.2-vision-11b`` (vlm: groups of self blocks and
one tanh-gated cross-attention block over image embeddings), and the
``audio`` and ``vlm`` variants of ``tests/test_models.py``, in f32, with the
JAX package's ``init_params(PRNGKey(0))`` carried across by
``params_from_numpy``: forward logits, prefill's last logits and cache (the
image K/V included), decode steps and greedy tokens match the reference to
1e-4.  The reference initialises the vlm gates at zero, which hides the
cross-attention from the logits, so the gates are set to non-zero values on
both sides (one case keeps them at zero).

Every config runs with ``backend="kernel"``: the flash wrapper takes any
head dim up to 128, the head dim 8 of the reduced deepseek and of both
``tests/test_models.py`` variants too (padded to 16 on the card; on the CPU
the plain version runs at head dim 8).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["deepseek-coder-33b", "musicgen-large", "llama-3.2-vision-11b"]
# tests/test_models.py's variants of the two families, at its vocab
VARIANTS = {
    "audio": dict(name="audio", family="audio", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=4, d_ff=64, vocab=64, embedding_inputs=True, mlp="gelu",
                  remat="none", dtype="float32"),
    "vlm": dict(name="vlm", family="vlm", n_layers=10, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, cross_attn_every=5, n_img_tokens=8, remat="none",
                dtype="float32"),
}
CASES = ARCHS + list(VARIANTS)
B, S, MAX_LEN, ATOL = 2, 12, 24, 1e-4


def _cfgs(case):
    if case in VARIANTS:
        return JModelConfig(**VARIANTS[case]), ModelConfig(**VARIANTS[case])
    return JCFG.get_reduced(case), TCFG.get_reduced(case)


def _backend(cfg):
    return "kernel" if cfg.hd() <= HEAD_DIMS[-1] else "ref"


@functools.lru_cache(maxsize=None)
def _jax_tree(case):
    """The reference's ``init_params(PRNGKey(0))`` as numpy, made once."""
    return jax.device_get(JM.init_params(_cfgs(case)[0], jax.random.PRNGKey(0)))


def _setup(case, gates=True):
    """Both configs, the reference's params (vlm gates drawn non-zero unless
    ``gates`` is False) on both sides, and numpy inputs: tokens or frame
    embeddings (B, S), plus image embeddings for the vlm."""
    jcfg, tcfg = _cfgs(case)
    tree = _jax_tree(case)
    if jcfg.family == "vlm" and gates:
        n = tree["cross_blocks"]["gate"].shape[0]
        sign = np.where(np.arange(n) % 2, -1.0, 1.0)
        gate = (np.random.default_rng(3).uniform(0.5, 1.5, n) * sign).astype(np.float32)
        tree = dict(tree, cross_blocks=dict(tree["cross_blocks"], gate=gate))
    tparams = params_from_numpy(tree, tcfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    if jcfg.embedding_inputs:
        inputs = {"embeddings": rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)}
    else:
        inputs = {"tokens": rng.integers(0, jcfg.vocab, (B, S))}
    if jcfg.family == "vlm":
        inputs["image_embeddings"] = rng.normal(
            0, 1, (B, jcfg.n_img_tokens, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, inputs


def _window(inputs, lo, hi):
    """Positions [lo, hi) of the sequence inputs; image embeddings whole."""
    return {k: v if k == "image_embeddings" else v[:, lo:hi] for k, v in inputs.items()}


def _step(inputs, i):
    """Decode step i's input: its token or frame, no image."""
    return {k: v[:, i:i + 1] for k, v in inputs.items() if k != "image_embeddings"}


def _jb(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def _cache_names(cfg):
    return ("k", "v", "img_k", "img_v") if cfg.family == "vlm" else ("k", "v")


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The copied configs carry the reference's values in every field, and
    the same derived sizes."""
    for getter in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (getter, f.name)
        assert (tcfg.hd(), tcfg.param_count()) == (jcfg.hd(), jcfg.param_count())


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_full_config_param_count_matches_spec(arch):
    """Twin of ``test_arch_smoke``'s check, at the reference's ranges, for
    every config the port registers."""
    n = TCFG.get_config(arch).param_count()
    expected = {
        "llama-3.2-vision-11b": (8.5e9, 12.5e9),
        "smollm-135m": (0.11e9, 0.16e9),
        "qwen2-1.5b": (1.2e9, 1.9e9),
        "olmo-1b": (0.9e9, 1.4e9),
        "deepseek-coder-33b": (30e9, 36e9),
        "musicgen-large": (2.2e9, 4.0e9),
        "falcon-mamba-7b": (6.0e9, 8.5e9),
        "arctic-480b": (430e9, 520e9),
        "dbrx-132b": (120e9, 145e9),
        "zamba2-7b": (6.0e9, 8.8e9),
    }[arch]
    assert expected[0] <= n <= expected[1], f"{arch}: {n / 1e9:.2f}B params"


def _flat_spec(tcfg):
    flat = jax.tree_util.tree_flatten_with_path(
        TM.param_spec(tcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
    return {jax.tree_util.keystr(k): (tuple(v[0]), str(v[1])[6:]) for k, v in flat}


@pytest.mark.parametrize("which", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_tree(arch, which):
    """``param_spec``'s names, shapes and dtypes equal the reference's
    ``init_params`` tree (the full configs' by ``abstract_params``, which
    allocates nothing): no ``embed`` and an ``lm_head`` for frame inputs, the
    vlm's ``self_blocks`` (G, E-1) and ``cross_blocks`` (G,) with an f32
    gate."""
    getter = "get_reduced" if which == "reduced" else "get_config"
    jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
    flat = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in flat}
    got = _flat_spec(tcfg)
    assert got == want
    assert ("['embed']" in got) != tcfg.embedding_inputs
    if tcfg.family == "vlm":
        g = tcfg.n_layers // tcfg.cross_attn_every
        assert got["['cross_blocks']['gate']"] == ((g,), "float32")
        assert got["['self_blocks']['attn']['wq']"][0][:2] == (g, tcfg.cross_attn_every - 1)


@pytest.mark.parametrize("case", CASES)
def test_params_round_trip(case):
    """``params_from_numpy`` takes the new trees unchanged, and the port's
    own init has the reference's names, shapes and dtypes."""
    jcfg, tcfg, jparams, tparams, _ = _setup(case)
    tree = jax.device_get(jparams)
    back = params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b, np.float32))
    own = TM.init_params(tcfg, seed=0, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(own)),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    jcfg, tcfg, jparams, tparams, inputs = _setup(case)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(jparams, _jb(inputs))
    got, aux = TM.forward(tparams, tcfg, _tb(inputs), backend=_backend(tcfg))
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case):
    """Prefill of 4 positions, then 3 teacher-forced decode steps: last
    logits, caches (each vlm group's image K/V included) and per-step
    logits as the reference's."""
    jcfg, tcfg, jparams, tparams, inputs = _setup(case)
    backend, half = _backend(tcfg), 4
    jlast, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, MAX_LEN))(
        jparams, _jb(_window(inputs, 0, half)))
    tlast, tcache = TM.prefill(tparams, tcfg, _tb(_window(inputs, 0, half)), MAX_LEN,
                               backend=backend)
    _close(tlast, jlast)
    assert tcache["len"] == int(jcache["len"]) == half
    assert sorted(tcache) == sorted(jcache)
    for name in _cache_names(tcfg):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name])
    jdec = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b))
    for i in range(half, half + 3):
        jl, jcache = jdec(jparams, jcache, _jb(_step(inputs, i)))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tb(_step(inputs, i)),
                                    backend=backend)
        _close(tl, jl)
    for name in _cache_names(tcfg):
        _close(tcache[name], jcache[name])
    assert tcache["len"] == int(jcache["len"]) == half + 3


@pytest.mark.parametrize("case", ["deepseek-coder-33b", "llama-3.2-vision-11b", "vlm"])
def test_greedy_tokens_match_jax(case):
    """The steps of both packages decode the same greedy tokens from the
    same prompt (and image)."""
    jcfg, tcfg, jparams, tparams, inputs = _setup(case)
    prompt = _window(inputs, 0, 6)
    jpre = jax.jit(JST.make_prefill_step(jcfg, MAX_LEN))
    jserve = jax.jit(JST.make_serve_step(jcfg))
    last, cache = jpre(jparams, _jb(prompt))
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok[:, 0])]
    for _ in range(5):
        out, cache = jserve(jparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    backend = _backend(tcfg)
    last, cache = TST.make_prefill_step(tcfg, MAX_LEN, backend)(tparams, _tb(prompt))
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    got = [tok[:, 0].numpy()]
    serve = TST.make_serve_step(tcfg, backend)
    for _ in range(5):
        out, cache = serve(tparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None]
        got.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("case", CASES)
def test_incremental_decode_matches_forward(case):
    """The port on its own: one position at a time (the vlm's first by a
    one-position prefill, which fills the image K/V) reproduces its full
    forward (the reference's ``tests/test_models.py`` check, at its
    tolerance)."""
    _, tcfg, _, tparams, inputs = _setup(case)
    backend = _backend(tcfg)
    ref, _ = TM.forward(tparams, tcfg, _tb(inputs), backend=backend)
    if tcfg.family == "vlm":
        lg, cache = TM.prefill(tparams, tcfg, _tb(_window(inputs, 0, 1)), S + 4,
                               backend=backend)
    else:
        cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
        lg, cache = TM.decode_step(tparams, tcfg, cache, _tb(_step(inputs, 0)),
                                   backend=backend)
    outs = [lg]
    for i in range(1, S):
        lg, cache = TM.decode_step(tparams, tcfg, cache, _tb(_step(inputs, i)),
                                   backend=backend)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_forward(case):
    """The port on its own: prefill of half the sequence, then one position
    at a time through the serve step, reproduces the full forward."""
    _, tcfg, _, tparams, inputs = _setup(case)
    backend = _backend(tcfg)
    ref, _ = TM.forward(tparams, tcfg, _tb(inputs), backend=backend)
    half = S // 2
    last, cache = TST.make_prefill_step(tcfg, S + 4, backend)(
        tparams, _tb(_window(inputs, 0, half)))
    _close(last[:, 0], ref[:, half - 1], 2e-3)
    serve = TST.make_serve_step(tcfg, backend)
    for i in range(half, S):
        out, cache = serve(tparams, cache, _tb(_step(inputs, i)))
        _close(out["logits"][:, 0], ref[:, i], 2e-3)


@pytest.mark.parametrize("case", CASES)
def test_decode_on_a_fresh_cache_matches_jax(case):
    """Twin of ``test_arch_smoke``'s decode step on a fresh cache: a zero
    token or frame; the vlm attends over zero image K/V."""
    jcfg, tcfg, jparams, tparams, _ = _setup(case)
    if jcfg.embedding_inputs:
        step = {"embeddings": np.zeros((B, 1, jcfg.d_model), np.float32)}
    else:
        step = {"tokens": np.zeros((B, 1), np.int64)}
    want, jcache = JM.decode_step(jparams, jcfg, JM.init_cache(jcfg, B, S), _jb(step))
    cache = TM.init_cache(tcfg, B, S, device="cpu")
    got, cache = TM.decode_step(tparams, tcfg, cache, _tb(step), backend=_backend(tcfg))
    assert got.shape == (B, 1, tcfg.vocab) and bool(torch.isfinite(got).all())
    assert cache["len"] == int(jcache["len"]) == 1
    _close(got, want)


@pytest.mark.parametrize("case", ["llama-3.2-vision-11b", "vlm"])
def test_zero_gates_match_jax_and_hide_the_image(case):
    """At the reference's own init (gates zero) forward and prefill match
    JAX, and the logits do not depend on the image; with the gates drawn
    non-zero they do."""
    jcfg, tcfg, jparams, tparams, inputs = _setup(case, gates=False)
    backend = _backend(tcfg)
    want, _ = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(jparams, _jb(inputs))
    got, _ = TM.forward(tparams, tcfg, _tb(inputs), backend=backend)
    _close(got, want)
    jlast, _ = JM.prefill(jparams, jcfg, _jb(_window(inputs, 0, 4)), MAX_LEN)
    tlast, _ = TM.prefill(tparams, tcfg, _tb(_window(inputs, 0, 4)), MAX_LEN, backend=backend)
    _close(tlast, jlast)
    other = dict(inputs, image_embeddings=-inputs["image_embeddings"])
    assert torch.equal(TM.forward(tparams, tcfg, _tb(other), backend=backend)[0], got)
    gated = _setup(case)[3]
    a, _ = TM.forward(gated, tcfg, _tb(inputs), backend=backend)
    b, _ = TM.forward(gated, tcfg, _tb(other), backend=backend)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["musicgen-large", "llama-3.2-vision-11b"])
def test_kernel_and_ref_backends_agree_on_cpu(case):
    """On CPU tensors the kernel backend runs the plain versions."""
    _, tcfg, _, tparams, inputs = _setup(case)
    a, _ = TM.forward(tparams, tcfg, _tb(inputs), backend="kernel")
    b, _ = TM.forward(tparams, tcfg, _tb(inputs), backend="ref")
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["deepseek-coder-33b", "audio", "vlm"])
def test_head_dim_8_runs_on_the_plain_backend(case):
    """The flash wrapper takes head dim 8, which the kernel has no instance
    for (the card pads it to 16): on the CPU the kernel backend runs the
    plain version at head dim 8, bit-equal to the plain backend."""
    _, tcfg, _, tparams, inputs = _setup(case)
    assert tcfg.hd() == 8 and _backend(tcfg) == "kernel"
    a, _ = TM.forward(tparams, tcfg, _tb(inputs), backend="kernel")
    b, _ = TM.forward(tparams, tcfg, _tb(inputs), backend="ref")
    assert torch.equal(a, b)


# --------------------------------------------------------- cross-attention
@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_block_matches_jax(s):
    """``attention_block(kv_override=src)`` as the reference's: K/V from the
    source through wk / wv, the bias and the rope on q only (non-zero biases,
    positions from 3), every key visible; the pre-projected (k, v) form
    gives the same output."""
    cfg_kw = dict(name="x", family="vlm", n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=64, vocab=64, qkv_bias=True, cross_attn_every=5, n_img_tokens=7,
                  dtype="float32")
    jcfg, tcfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    rng = np.random.default_rng(6)
    p = {n: rng.normal(0, 0.2, (64, 64)).astype(np.float32) for n in ("wq", "wo")}
    p.update({n: rng.normal(0, 0.2, (64, 32)).astype(np.float32) for n in ("wk", "wv")})
    p.update(bq=rng.normal(0, 0.5, 64).astype(np.float32),
             bk=rng.normal(0, 0.5, 32).astype(np.float32),
             bv=rng.normal(0, 0.5, 32).astype(np.float32))
    x = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    src = rng.normal(0, 1, (2, 7, 64)).astype(np.float32)
    pos = np.arange(3, 3 + s)
    want, _ = JL.attention_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                 jcfg, jnp.asarray(pos), kv_override=jnp.asarray(src))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (torch.from_numpy(x), tp, tcfg, torch.from_numpy(pos))
    got, cache = L.attention_block(*args, kv_override=torch.from_numpy(src))
    assert cache is None
    _close(got, want, 1e-5)
    kv = L.cross_kv(torch.from_numpy(src), tp, tcfg)
    assert torch.equal(L.attention_block(*args, kv_override=kv)[0], got)


def test_vlm_decode_with_qkv_bias_matches_jax():
    """A vlm with ``qkv_bias`` and non-zero biases everywhere: prefill, then
    decode steps, as the reference's.  The reference puts the cross blocks'
    ``bq`` on the queries in a prefill (``attention_block``) and leaves it
    out of a decode step's cross-attention over the cached image K/V; the
    port does the same: zeroing the cross ``bq`` moves its prefill and not
    its decode step."""
    kw = dict(VARIANTS["vlm"], name="vlm-bias", d_model=64, qkv_bias=True)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    tree = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    for blocks in ("self_blocks", "cross_blocks"):
        for n in ("bq", "bk", "bv"):
            shape = tree[blocks]["attn"][n].shape
            tree[blocks]["attn"][n] = rng.normal(0, 0.5, shape).astype(np.float32)
    tree["cross_blocks"]["gate"] = np.full(tree["cross_blocks"]["gate"].shape, 0.8, np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    inputs = {"tokens": rng.integers(0, jcfg.vocab, (B, S)),
              "image_embeddings": rng.normal(0, 1, (B, jcfg.n_img_tokens, 64)).astype(np.float32)}
    backend, half = _backend(tcfg), 4
    assert backend == "kernel"
    jlast, jcache = JM.prefill(jparams, jcfg, _jb(_window(inputs, 0, half)), MAX_LEN)
    tlast, tcache = TM.prefill(tparams, tcfg, _tb(_window(inputs, 0, half)), MAX_LEN,
                               backend=backend)
    _close(tlast, jlast)
    jdec = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b))
    for i in range(half, half + 3):
        jl, jcache = jdec(jparams, jcache, _jb(_step(inputs, i)))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tb(_step(inputs, i)),
                                    backend=backend)
        _close(tl, jl)
    no_bq = dict(tparams, cross_blocks=dict(tparams["cross_blocks"], attn=dict(
        tparams["cross_blocks"]["attn"], bq=torch.zeros_like(tparams["cross_blocks"]["attn"]["bq"]))))
    moved, _ = TM.prefill(no_bq, tcfg, _tb(_window(inputs, 0, half)), MAX_LEN, backend=backend)
    assert float((moved - tlast).abs().max()) > 1e-3
    step = _tb(_step(inputs, half + 3))
    cache = {k: v.clone() if torch.is_tensor(v) else v for k, v in tcache.items()}
    a, _ = TM.decode_step(tparams, tcfg, tcache, step, backend=backend)
    b, _ = TM.decode_step(no_bq, tcfg, cache, step, backend=backend)
    assert torch.equal(a, b)
