"""The port's MoE family (``arctic-480b``, ``dbrx-132b``) against the JAX
package's, on the CPU.

The reduced configs and ``tests/test_models.py``'s ``moe`` variant run in
f32 with the JAX package's ``init_params(PRNGKey(0))`` carried across by
``params_from_numpy``: forward logits and aux, prefill, decode steps and
greedy tokens match the reference to 1e-4.  ``moe_ffn`` alone matches the
reference's flat and grouped dispatch to 1e-5 for ``moe_groups`` 0, 1, 4
and 8, also under capacity pressure, where ``moe_route`` shows the drops
(so the match shows the same drops), and on a decode step down each branch
of the dispatcher.  ``keep`` equals a numpy recomputation from the top-k ids
alone.  The launcher applies the reference's tuning (``moe_groups=16`` for
the full MoE archs) and serves the reference launcher's greedy tokens.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
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
from repro.launch import steps as JST  # noqa: E402
from repro.launch.tuned import apply_tuning as j_apply_tuning  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.launch.tuned import apply_tuning  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["arctic-480b", "dbrx-132b"]
# tests/test_models.py's moe variant, at its vocab (its capacity factor
# leaves no drop at B 2, S 12, so decode equals forward)
VARIANT = dict(name="moe", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
               d_ff=64, vocab=64, n_experts=4, top_k=2, moe_dff=48, dense_residual=True,
               remat="none", dtype="float32", capacity_factor=2.5)
CASES = ARCHS + ["moe"]
B, S, MAX_LEN, ATOL = 2, 12, 24, 1e-4


def _cfgs(case):
    if case == "moe":
        return JModelConfig(**VARIANT), ModelConfig(**VARIANT)
    return JCFG.get_reduced(case), TCFG.get_reduced(case)


def _backend(cfg):
    return "kernel" if cfg.hd() <= HEAD_DIMS[-1] else "ref"


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


def _jt(tokens):
    return {"tokens": jnp.asarray(tokens, jnp.int32)}


def _tt(tokens):
    return {"tokens": torch.from_numpy(np.asarray(tokens))}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """The copied configs carry the reference's values in every field the
    port keeps, and the same derived sizes, active parameters included."""
    for getter in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (getter, f.name)
        assert (tcfg.hd(), tcfg.param_count(), tcfg.active_param_count()) == (
            jcfg.hd(), jcfg.param_count(), jcfg.active_param_count())


@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_tuning_matches_jax(arch):
    """The launcher's tuning gives every arch the reference's ``moe_groups``
    (16 for the full MoE archs, none for a reduced config)."""
    for getter in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
        assert apply_tuning(tcfg).moe_groups == j_apply_tuning(jcfg).moe_groups
    assert apply_tuning(TCFG.get_config(arch)).moe_groups == (16 if arch in ARCHS else 0)
    assert apply_tuning(TCFG.get_reduced(arch)).moe_groups == 0


def test_full_config_param_counts():
    """The reference's parameter counts: about 477 B (15.6 B active) and
    131.6 B (36.5 B active)."""
    counts = {a: (TCFG.get_config(a).param_count(), TCFG.get_config(a).active_param_count())
              for a in ARCHS}
    assert counts == {"arctic-480b": (476_850_275_328, 15_584_314_368),
                      "dbrx-132b": (131_596_523_520, 36_469_708_800)}


def _flat_spec(tcfg):
    flat = jax.tree_util.tree_flatten_with_path(
        TM.param_spec(tcfg), is_leaf=lambda x: isinstance(x, tuple))[0]
    return {jax.tree_util.keystr(k): (tuple(v[0]), str(v[1])[6:]) for k, v in flat}


@pytest.mark.parametrize("which", ["reduced", "full", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_tree(arch, which):
    """``param_spec``'s names, shapes and dtypes equal the reference's tree
    (the full configs' by ``abstract_params``): a block holds ``moe`` and no
    ``mlp``, the router f32 whatever the activation dtype, ``dense`` only
    with the dense residual."""
    getter = "get_reduced" if which != "full" else "get_config"
    jcfg, tcfg = getattr(JCFG, getter)(arch), getattr(TCFG, getter)(arch)
    if which == "bf16":
        jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, tcfg))
    flat = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in flat}
    got = _flat_spec(tcfg)
    assert got == want
    e, d = tcfg.n_experts, tcfg.d_model
    assert got["['blocks']['moe']['router']"] == ((tcfg.n_layers, d, e), "float32")
    assert got["['blocks']['moe']['w2']"][0] == (tcfg.n_layers, e, tcfg.moe_dff, d)
    assert ("['blocks']['moe']['dense']['w1']" in got) == tcfg.dense_residual
    assert not any("['mlp']" in k for k in got)


@pytest.mark.parametrize("case", CASES)
def test_params_round_trip(case):
    """``params_from_numpy`` takes the moe tree unchanged and
    ``params_to_numpy`` gives it back; a bf16 tree keeps its router f32;
    the port's own init has the reference's names, shapes and dtypes."""
    jcfg, tcfg = _cfgs(case)
    tree = _jax_tree(case)
    back = params_to_numpy(params_from_numpy(tree, tcfg, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b, np.float32))
    own = TM.init_params(tcfg, seed=0, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(own)),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    tb = dataclasses.replace(tcfg, dtype="bfloat16")
    tree_bf = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "router" in jax.tree_util.keystr(path) else a.astype(jnp.bfloat16),
        tree)
    bf = params_from_numpy(tree_bf, tb, "cpu")
    assert bf["blocks"]["moe"]["router"].dtype == torch.float32
    assert bf["blocks"]["moe"]["w1"].dtype == torch.bfloat16


# ------------------------------------------------------------ the MoE FFN
_J_FLAT = jax.jit(JMOE.moe_ffn_flat, static_argnums=2)
_J_GROUPED = jax.jit(JMOE.moe_ffn_grouped, static_argnums=2)


def _layer_params(case, cf, groups):
    """Layer 0's moe params on both sides, and configs with ``cf`` and
    ``groups`` set."""
    jcfg, tcfg = _cfgs(case)
    jcfg, tcfg = (dataclasses.replace(c, capacity_factor=cf, moe_groups=groups)
                  for c in (jcfg, tcfg))
    p = jax.tree.map(lambda a: np.array(a[0]), _jax_tree(case)["blocks"]["moe"])
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)


def _both_ffn(case, shape, cf, groups, seed=2):
    """The reference's ``moe_ffn_grouped`` or ``moe_ffn_flat``, the one its
    dispatcher (``moe_ffn``) takes, and the port's ``moe_ffn`` on the same
    input; returns both outputs and auxes, and the port's routing."""
    jcfg, tcfg, jp, tp = _layer_params(case, cf, groups)
    x = np.random.default_rng(seed).normal(0, 1, (*shape, jcfg.d_model)).astype(np.float32)
    t = x.shape[0] * x.shape[1]
    grouped = groups and t >= groups and t % groups == 0
    want, jaux = (_J_GROUPED if grouped else _J_FLAT)(jnp.asarray(x), jp, jcfg)
    got, aux = TMOE.moe_ffn(torch.from_numpy(x), tp, tcfg)
    return got, aux, want, jaux, TMOE.moe_route(torch.from_numpy(x), tp, tcfg)


# capacity_factor 1.0 at 256 tokens: every path drops (each group's mean
# load per expert equals its capacity, 8 or more)
@pytest.mark.parametrize("pressure", [False, True], ids=["no-drops", "pressure"])
@pytest.mark.parametrize("groups", [0, 1, 4, 8])
@pytest.mark.parametrize("case", ARCHS)
def test_moe_ffn_matches_jax(case, groups, pressure):
    """``moe_ffn`` against the reference's at 4 x 64 tokens, flat (0, 1)
    and grouped (4, 8): under pressure ``moe_route`` drops assignments and
    the outputs still match, so the drops are the reference's."""
    cf = 1.0 if pressure else 8.0
    got, aux, want, jaux, route = _both_ffn(case, (4, 64), cf, groups)
    assert route["groups"] == (groups or 1)
    drops = int((~route["keep"]).sum())
    assert (drops > 0) == pressure, drops
    _close(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("batch,groups,branch", [(16, 16, 16), (8, 16, 1), (12, 8, 1),
                                                 (16, 8, 8)],
                         ids=["B=g", "B<g", "B%g", "B=2g"])
def test_decode_step_takes_the_reference_branch(batch, groups, branch):
    """A decode step (S = 1) of ``batch`` rows: grouped where the rows tile
    the groups (at B = g each group holds one token, cap 8), flat
    otherwise, each as the reference's dispatcher computes it."""
    got, _, want, _, route = _both_ffn("dbrx-132b", (batch, 1), 1.25, groups)
    assert route["groups"] == branch
    assert route["cap"] == TMOE.capacity(TCFG.get_reduced("dbrx-132b"), batch // branch) == 8
    _close(got, want, 1e-5)


def test_full_width_dispatch_shapes():
    """The chip run's dispatch at the tuned full configs: dbrx's prefill of
    8 x 512 grouped (256 tokens a group, cap 80), its decode at batch 8
    flat (cap 8); arctic's prefill grouped at cap 8."""
    dbrx = apply_tuning(TCFG.get_config("dbrx-132b"))
    arctic = apply_tuning(TCFG.get_config("arctic-480b"))
    assert TMOE.n_groups(dbrx, 4096) == 16 and TMOE.capacity(dbrx, 256) == 80
    assert TMOE.n_groups(dbrx, 8) == 1 and TMOE.capacity(dbrx, 8) == 8
    assert TMOE.n_groups(arctic, 4096) == 16 and TMOE.capacity(arctic, 256) == 8
    assert TMOE.n_groups(arctic, 16) == 16 and TMOE.capacity(arctic, 1) == 8


def _numpy_keep(expert_idx, groups, cap, n_experts):
    """The keep mask from the top-k ids alone: each assignment's rank among
    its expert's in (token, rank) order, within its group, below ``cap``."""
    t, k = expert_idx.shape
    keep = np.zeros((t, k), bool)
    for g in range(groups):
        seen = np.zeros(n_experts, int)
        for i in range(g * t // groups, (g + 1) * t // groups):
            for r in range(k):
                e = expert_idx[i, r]
                keep[i, r] = seen[e] < cap
                seen[e] += 1
    return keep


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("case", ARCHS)
def test_keep_matches_numpy_ranking(case, groups):
    """``moe_route``'s keep mask equals the stable-rank recomputation, and
    ``dest`` gives each kept assignment its own slot."""
    _, tcfg, _, tp = _layer_params(case, 1.0, groups)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (4, 32, tcfg.d_model))
                         .astype(np.float32))
    r = TMOE.moe_route(x, tp, tcfg)
    want = _numpy_keep(r["expert_idx"].numpy(), r["groups"], r["cap"], tcfg.n_experts)
    assert (~want).sum() > 0
    np.testing.assert_array_equal(r["keep"].numpy(), want)
    dest = r["dest"].numpy() + (np.arange(128) // (128 // r["groups"]))[:, None] * 10**6
    kept = dest[r["keep"].numpy()]
    assert len(np.unique(kept)) == kept.size
    assert (r["dest"].numpy()[~want] == tcfg.n_experts * r["cap"]).all()


def test_grouped_equals_flat_without_drops():
    """``tests/test_moe_grouped.py``'s check on the port: with room for
    every assignment, grouping changes nothing (forward logits and aux)."""
    cfg = ModelConfig(**dict(VARIANT, capacity_factor=8.0))
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = _tt(np.random.default_rng(1).integers(0, 64, (4, 16)))
    ref, aux = TM.forward(params, cfg, toks, backend="ref")
    for g in (1, 2, 4, 8):
        got, a = TM.forward(params, dataclasses.replace(cfg, moe_groups=g), toks, backend="ref")
        _close(got, ref, 2e-5)
        np.testing.assert_allclose(float(a), float(aux), rtol=1e-5)


def test_moe_ffn_is_deterministic_and_sums_in_expert_order():
    """Two calls give the same bits; in bf16 each token's k contributions
    are summed in ascending expert order from zeros, as a sequential
    scatter-add meets them."""
    _, tcfg, _, tp = _layer_params("dbrx-132b", 1.0, 4)
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (4, 32, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    a, _ = TMOE.moe_ffn(x, tp, cfg)
    b, _ = TMOE.moe_ffn(x, tp, cfg)
    assert torch.equal(a, b)
    r = TMOE.moe_route(x, tp, cfg)
    tokens = x.reshape(-1, cfg.d_model)
    want = torch.zeros_like(tokens)
    for i in range(tokens.shape[0]):
        for e in sorted(r["expert_idx"][i].tolist()):
            j = r["expert_idx"][i].tolist().index(e)
            if not r["keep"][i, j]:
                continue
            xe = tokens[i:i + 1]
            h = torch.nn.functional.silu(xe @ tp["w1"][e]) * (xe @ tp["w3"][e])
            want[i] = want[i] + ((h @ tp["w2"][e]).float() * r["gates"][i, j]).to(x.dtype)[0]
    assert torch.equal(a.reshape(-1, cfg.d_model), want)


# --------------------------------------------------------------- the model
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    want, jaux = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(jparams, _jt(tokens))
    got, aux = TM.forward(tparams, tcfg, _tt(tokens), backend=_backend(tcfg))
    assert got.shape == (B, S, tcfg.vocab) and float(aux) > 0
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case):
    """Prefill of 4 positions (grouped where the config groups), then 3
    teacher-forced decode steps: last logits, caches and per-step logits
    as the reference's."""
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    if case != "moe":  # a grouped prefill (8 tokens in 4 groups), flat steps
        jcfg, tcfg = (dataclasses.replace(c, moe_groups=4) for c in (jcfg, tcfg))
    backend, half = _backend(tcfg), 4
    jlast, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, MAX_LEN))(
        jparams, _jt(tokens[:, :half]))
    tlast, tcache = TM.prefill(tparams, tcfg, _tt(tokens[:, :half]), MAX_LEN, backend=backend)
    _close(tlast, jlast)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    jdec = jax.jit(lambda p, c, b: JM.decode_step(p, jcfg, c, b))
    for i in range(half, half + 3):
        jl, jcache = jdec(jparams, jcache, _jt(tokens[:, i:i + 1]))
        tl, tcache = TM.decode_step(tparams, tcfg, tcache, _tt(tokens[:, i:i + 1]),
                                    backend=backend)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    assert tcache["len"] == int(jcache["len"]) == half + 3


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_jax(case):
    jcfg, tcfg, jparams, tparams, tokens = _setup(case)
    prompt = tokens[:, :6]
    last, cache = jax.jit(JST.make_prefill_step(jcfg, MAX_LEN))(jparams, _jt(prompt))
    jserve = jax.jit(JST.make_serve_step(jcfg))
    tok = jnp.argmax(last[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok[:, 0])]
    for _ in range(5):
        out, cache = jserve(jparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    backend = _backend(tcfg)
    last, cache = TST.make_prefill_step(tcfg, MAX_LEN, backend)(tparams, _tt(prompt))
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    got = [tok[:, 0].numpy()]
    serve = TST.make_serve_step(tcfg, backend)
    for _ in range(5):
        out, cache = serve(tparams, cache, {"tokens": tok})
        tok = out["next_token"][:, None]
        got.append(tok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_incremental_decode_matches_forward():
    """The port on its own, at the variant's no-drop capacity: one position
    at a time reproduces the full forward (``tests/test_models.py``'s
    check, at its tolerance)."""
    _, tcfg, _, tparams, tokens = _setup("moe")
    ref, _ = TM.forward(tparams, tcfg, _tt(tokens), backend="ref")
    cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    outs = []
    for i in range(S):
        lg, cache = TM.decode_step(tparams, tcfg, cache, _tt(tokens[:, i:i + 1]), backend="ref")
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), rtol=2e-2, atol=2e-3)


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_tunes_the_full_configs(arch):
    """``serve`` builds the reference launcher's configuration: the full
    arch tuned (``moe_groups`` 16), the reduced one untuned; ``cfg=``
    overrides it."""
    for reduced, groups in (([], 16), (["--reduced"], 0)):
        args = TV.build_parser().parse_args(
            ["--arch", arch, "--tier-only", "--sessions", "2", "--device", "cpu", *reduced])
        with contextlib.redirect_stdout(io.StringIO()):
            out = TV.serve(args)
        assert out["cfg"].moe_groups == groups and out["cfg"].name.startswith(arch)
    cut = dataclasses.replace(apply_tuning(TCFG.get_config(arch)), n_layers=2)
    with contextlib.redirect_stdout(io.StringIO()):
        assert TV.serve(args, cfg=cut)["cfg"] is cut


# The reference launcher in a subprocess, its jitted steps wrapped so that
# it prints the greedy tokens it serves (it prints no token itself): each
# prefill's argmax and each step's next token, one JSON line a call
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


def test_launcher_serves_the_reference_tokens():
    """``python -m repro.launch.serve --arch arctic-480b --reduced`` (a
    subprocess) and the port's launcher with the same flags and the
    reference's ``init_params(PRNGKey(0))``: the same report lines and the
    same greedy tokens, batch by batch."""
    argv = ["--arch", "arctic-480b", "--reduced", "--batch", "2", "--prompt-len", "6",
            "--gen", "4", "--sessions", "4"]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REF_TOKENS, *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr
    want = [json.loads(line[7:]) for line in ref.stdout.splitlines()
            if line.startswith("TOKENS ")]
    jcfg = j_apply_tuning(JCFG.get_reduced("arctic-480b"))
    tree = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, TCFG.get_reduced("arctic-480b"), "cpu")
    got = []

    def hook(sids, prompts, last, tokens):
        got.extend(tokens[:, i].tolist() for i in range(tokens.shape[1]))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TV.serve(TV.build_parser().parse_args(argv + ["--device", "cpu"]),
                       params=params, hook=hook)
    assert out["batches"] == 2 and len(want) == 8
    assert got == want

    def summary(text):
        return [re.sub(r" tok in \d+ ms.*", " tok", line) for line in text.splitlines()
                if not line.startswith(("TOKENS ", "model:"))]

    assert summary(buf.getvalue()) == summary(ref.stdout)
