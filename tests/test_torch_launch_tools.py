"""The port's launch tooling against the JAX package's, on the CPU.

``launch/sharding.py``'s spec trees leaf for leaf against the reference's
rules for all ten archs at full width on both production meshes (the
reference's rule functions read only ``mesh.axis_names`` and ``mesh.shape``,
so a stand-in of the 512-device mesh serves them): parameters, AdamW state,
the batch of every shape and the decode caches of the shapes ``supports()``
allows; one device's block of a leaf; ``launch/mesh.py``'s meshes;
``launch/tuned.py``'s table and the tuned reduced smoke of ``test_tuned.py``
with logits and loss within 1e-4 of the reference's; the dry run
(``launch/dryrun.py``) of every reduced arch x supported shape on ``meta``,
a reduced dense cell's FLOPs against a hand count of its products, its
predicted peak against a live-bytes count, the probes' sum(trips x body) +
rest against the whole step (``launch/probe.py``), the CLIs; and
``launch/hillclimb.py`` on every variant.
"""

import ast
import dataclasses
import functools
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.configs import shapes as JSH  # noqa: E402
from repro.launch import sharding as JSHARD  # noqa: E402
from repro.launch.tuned import TUNED as J_TUNED  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeCfg, input_specs, supports  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.tuned import TUNED, apply_tuning  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = TCFG.ARCH_IDS
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(kind):
    """The reference's production mesh as its rules read it."""
    dims, axes = MESHES[kind]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def _port_specs(tree):
    """A spec tree's leaves in the pytree order (dicts by sorted key; the
    spec tuples are the leaves)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    return [tree]


def _backend(cfg):
    return "kernel" if cfg.hd() <= HEAD_DIMS[-1] else "ref"


# ------------------------------------------------------------------ sharding
@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_the_reference(arch, kind):
    jcfg, tcfg = JCFG.get_config(arch), TCFG.get_config(arch)
    jmesh, tmesh = _stand_in(kind), MESH.make_production_mesh(multi_pod=kind == "multi")
    assert tuple(tmesh.axis_names) == jmesh.axis_names and tmesh.shape == jmesh.shape
    jparams, tparams = JM.abstract_params(jcfg), TM.abstract_params(tcfg)
    jp, tp = JSHARD.param_pspecs(jparams, jcfg, jmesh), SH.param_pspecs(tparams, tcfg, tmesh)
    assert _port_specs(tp) == _jax_specs(jp)
    jo = JSHARD.opt_pspecs(None, jp)
    to = SH.opt_pspecs(init_opt_state(tparams, AdamWConfig()), tp)
    assert _port_specs(to) == _jax_specs(jo)
    for shape in SHAPES:
        if not supports(arch, shape):
            continue
        jin, tin = JSH.input_specs(jcfg, shape), input_specs(tcfg, shape)
        assert (_port_specs(SH.batch_pspecs(tin["batch"], tmesh))
                == _jax_specs(JSHARD.batch_pspecs(jin["batch"], jmesh))), shape
        if "cache" in jin:
            b = SHAPES[shape].global_batch
            want = _jax_specs(JSHARD.cache_pspecs(jin["cache"], jcfg, jmesh, b))
            assert _port_specs(SH.cache_pspecs(tin["cache"], tcfg, tmesh, b)) == want, shape


def test_local_shape_and_sharded_bytes():
    """One device's block: each dimension divided, rounded up, by the sizes
    of the axes its entry names."""
    single, multi = MESH.make_production_mesh(), MESH.make_production_mesh(multi_pod=True)
    assert SH.local_shape((100352, 6144), ("model", "data"), single) == (6272, 384)
    assert SH.local_shape((100352, 6144), ("model", ("pod", "data")), multi) == (6272, 192)
    assert SH.local_shape((40, 6144, 10), (None, "data", None), single) == (40, 384, 10)
    assert SH.local_shape((3, 5), (), single) == (3, 5)
    assert SH.local_shape((17,), ("model",), single) == (2,)
    tree = {"a": torch.empty((32, 64), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty((), dtype=torch.int32, device="meta")}, "len": 7}
    specs = {"a": ("data", "model"), "b": {"c": ()}, "len": ()}
    assert SH.sharded_bytes(tree, specs, single) == 2 * 4 * 2 + 4
    assert SH.sharded_bytes(tree, specs, MESH.make_card_mesh()) == 32 * 64 * 2 + 4


def test_meshes():
    single, multi = MESH.make_production_mesh(), MESH.make_production_mesh(multi_pod=True)
    assert (single.dims, single.axis_names, single.size) == ((16, 16), ("data", "model"), 256)
    assert (multi.dims, multi.axis_names, multi.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and not multi.devices
    assert MESH.data_axes(single) == ("data",) and MESH.data_axes(multi) == ("pod", "data")
    card = MESH.make_card_mesh()
    assert card.shape == {"data": 1, "model": 1} and card.size == 1
    with pytest.raises(RuntimeError, match="needs 256 devices, have 1"):
        MESH.make_production_mesh(devices=["cuda:0"])
    assert MESH.make_production_mesh(devices=[f"cuda:{i}" for i in range(300)]).devices[-1] == \
        "cuda:255"
    host = MESH.make_host_mesh()
    assert host.size == 1 and host.devices == ("cpu",)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        MESH.make_host_mesh((1, 2))


# --------------------------------------------------------------------- tuning
def test_tuned_table_matches_the_reference():
    assert set(TUNED) == set(TCFG.ARCH_IDS) == set(J_TUNED)
    for arch in TCFG.ARCH_IDS:
        assert TUNED[arch] == J_TUNED[arch], arch
        assert apply_tuning(TCFG.get_reduced(arch)) == TCFG.get_reduced(arch)  # by name only


def _tuned_batch(cfg, vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeddings"] = (rng.standard_normal((2, cfg.n_img_tokens, cfg.d_model))
                                     * 0.02).astype(np.float32)
    if cfg.embedding_inputs:
        batch = {"embeddings": (rng.standard_normal((2, 16, cfg.d_model)) * 0.02).astype(
            np.float32), "labels": toks}
    return batch


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, groups):
    cfg = dataclasses.replace(JCFG.get_reduced(arch), **_tuned_overrides(arch, groups))
    return jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))


def _tuned_overrides(arch, groups=4):
    out = dict(TUNED[arch])
    if "moe_groups" in out:  # the group count must divide the smoke's tokens
        out["moe_groups"] = groups
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tuned_reduced_smoke_matches_jax(arch):
    """``test_tuned.py``'s smoke for the port: the reduced config with the
    arch's tuning, forward logits, the loss and a decode step's logits
    within 1e-4 of the reference's, from the reference's parameters."""
    over = _tuned_overrides(arch)
    jcfg = dataclasses.replace(JCFG.get_reduced(arch), **over)
    tcfg = dataclasses.replace(TCFG.get_reduced(arch), **over)
    tree = _jax_tree(arch, 4)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg, "cpu")
    batch = _tuned_batch(jcfg, jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    be = _backend(tcfg)
    want, _ = JM.forward(jparams, jcfg, jb)
    got, _ = TM.forward(tparams, tcfg, tb, backend=be)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(TM.loss_fn(tparams, tcfg, tb, backend=be)),
                               float(JM.loss_fn(jparams, jcfg, jb)), atol=1e-4, rtol=1e-4)
    step = ({"embeddings": np.zeros((2, 1, jcfg.d_model), np.float32)} if jcfg.embedding_inputs
            else {"tokens": np.zeros((2, 1), np.int32)})
    want, _ = JM.decode_step(jparams, jcfg, JM.init_cache(jcfg, 2, 16),
                             {k: jnp.asarray(v) for k, v in step.items()})
    got, _ = TM.decode_step(tparams, tcfg, TM.init_cache(tcfg, 2, 16, device="cpu"),
                            {k: torch.from_numpy(v) for k, v in step.items()}, backend=be)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_every_reduced_cell(arch):
    """Every shape the arch supports, at the shapes' own batch and length,
    with the reduced widths, on meta on the single mesh."""
    cfg = TCFG.get_reduced(arch)
    for shape in SHAPES:
        if not supports(arch, shape):
            continue
        res = DR.run_cell(arch, shape, "single", reduced=True, backend=_backend(cfg))
        mem = res["memory"]
        assert res["flops"] > 0 and res["bytes_accessed"] > 0, shape
        assert mem["peak_bytes"] >= mem["argument_bytes_total"] >= mem["argument_bytes"] > 0
        assert res["collectives"] is None and "one card" in res["collectives_note"]
        assert res["params"] == cfg.param_count() and res["n_devices"] == 256
        if _backend(cfg) == "kernel" and cfg.family != "ssm" and SHAPES[shape].kind != "decode":
            assert res["kernels"]["flash_attention"]["calls"] > 0, shape


def _hand_count(cfg, b, s, remat):
    """The matrix-product FLOPs of one training step of a dense config:
    each layer's weight products (the backward's two for each), the flash
    kernels' causal pairs (forward 4, backward 14 FLOPs a pair and head
    dim), the forward again where remat recomputes it but for its last
    product (the MLP's w2: no backward reads its output, and the
    non-reentrant checkpoint stops once it has what the backward needs),
    and the head."""
    t, d, hd, hq, hkv, f = b * s, cfg.d_model, cfg.hd(), cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    weights = 2 * t * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f)
    pairs = s * (s + 1) // 2
    fwd = weights + 4 * b * hq * hd * pairs
    bwd = 2 * weights + 14 * b * hq * hd * pairs
    recompute = fwd - 2 * t * f * d if remat != "none" else 0
    per_layer = fwd + recompute + bwd
    return cfg.n_layers * per_layer + 3 * 2 * t * d * cfg.vocab


@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
def test_dense_flops_equal_a_hand_count(remat):
    cfg = dataclasses.replace(TCFG.get_reduced("smollm-135m"), remat=remat)
    res = DR.measure_step(cfg, ShapeCfg("t", 32, 2, "train"), MESH.make_card_mesh())
    assert res["flops"] == _hand_count(cfg, 2, 32, remat)
    kernels = {k: v["calls"] for k, v in res["kernels"].items()}
    again = remat != "none"
    L = cfg.n_layers
    assert kernels == {"rmsnorm": 2 * L + 1 + again * 2 * L, "rmsnorm_bwd": 2 * L + 1,
                       "flash_attention": L * (1 + again), "flash_attention_bwd": L}


def test_kernel_wrappers_on_meta():
    """On ``meta`` tensors the wrappers allocate the kernels' outputs,
    launch nothing, count no launch, and report their products and bytes."""
    from repro_torch.kernels import meta
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as SK
    from repro_torch.kernels.rmsnorm import kernel as RK

    m = functools.partial(torch.empty, device="meta", dtype=torch.bfloat16)
    seen = []
    before = {**FK.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}
    with meta.account(lambda *a: seen.append(a)):
        q, kv = m((2, 48, 8, 64)), m((2, 48, 2, 64))
        out, lse = FK.flash_attention_lse(q, kv, kv)
        FK.flash_attention_bwd(q, kv, kv, out, lse, out)
        RK.rmsnorm(m((96, 576)), m((576,)))
        y, h, hs = SK.selective_scan_states(
            m((2, 64, 32)), torch.empty((32, 16), device="meta"), m((2, 64, 16)),
            m((2, 64, 16)), m((2, 64, 32)), torch.empty(32, device="meta"),
            dt_bias=m((32,)), z=m((2, 64, 32)))
    assert {**FK.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES} == before
    assert out.shape == q.shape and lse.shape == (2, 8, 48) and lse.dtype == torch.float32
    assert (y.shape, h.shape, hs.shape) == ((2, 64, 32), (2, 32, 16), (2, 2, 32, 16))
    pairs = 48 * 49 // 2
    assert [(n, f) for n, f, _ in seen] == [
        ("flash_attention", 4 * 2 * 8 * 64 * pairs),
        ("flash_attention_bwd", 14 * 2 * 8 * 64 * pairs), ("rmsnorm", 0), ("selective_scan", 0)]
    assert seen[2][2] == 2 * (2 * 96 * 576 + 576)
    assert meta.attention_pairs(4, 10, True) == 10 and meta.attention_pairs(6, 3, True) == 15
    assert meta.attention_pairs(4, 10, False) == 40


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
def test_flash_bwd_on_meta_is_the_kernels_call(hd, dtype):
    """The flash backward on ``meta`` at each head dim: it notes the FLOPs of
    the function's products that its kernels run (7 a visible pair, 2 hd
    each; a head dim the kernels pad in shared memory counts unpadded) and
    allocates exactly what the CUDA path does: dq, dk, dv and the f32
    scratch ((B, Hq, 2, S rounded up to 128) for bf16, where the preprocess
    kernel writes the scaled LSE and D; D, (B, Hq, S), for f32)."""
    from repro_torch.kernels.flash_attention import kernel as FK

    b, s, t, hq, hkv = 2, 48, 48, 8, 2
    dt = getattr(torch, dtype)
    q, o, do = (torch.empty((b, s, hq, hd), device="meta", dtype=dt) for _ in range(3))
    k, v = (torch.empty((b, t, hkv, hd), device="meta", dtype=dt) for _ in range(2))
    lse = torch.empty((b, hq, s), device="meta")
    held = [q, k, v, o, lse, do]
    got = DR.count(lambda: FK.flash_attention_bwd(q, k, v, o, lse, do), held)
    pairs = s * (s + 1) // 2
    grads = dt.itemsize * (q.numel() + k.numel() + v.numel())
    inputs = sum(x.numel() * x.element_size() for x in held)
    assert got["kernels"]["flash_attention_bwd"] == {
        "calls": 1, "flops": 14 * hd * b * hq * pairs, "bytes": inputs + grads}
    scratch = 4 * b * hq * (2 * 128 if dtype == "bfloat16" else s)
    assert got["peak_bytes"] == inputs + grads + scratch


def test_dry_run_peak_counts_live_bytes():
    """The tracker's peak on a step whose live bytes are known: a product
    and its sum on meta."""
    a = torch.empty((64, 32), device="meta")
    w = torch.empty((32, 128), device="meta")

    def fn():
        y = a @ w  # 64 x 128 f32 alive with a and w
        return (y * 2).sum()  # a second 64 x 128 while y lives

    got = DR.count(fn, [a, w])
    assert got["peak_bytes"] == 4 * (64 * 32 + 32 * 128 + 2 * 64 * 128 + 1)  # and the sum
    assert got["flops"] == 2 * 64 * 32 * 128


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "zamba2-7b",
                                  "llama-3.2-vision-11b", "dbrx-132b"])
def test_probe_sum_equals_the_whole_step(arch, kind):
    sh = ShapeCfg("small", 32, 2, kind)
    whole = DR.run_cell(arch, sh, "single", reduced=True)
    probed = DR.run_bodies(arch, sh, "single", reduced=True)
    assert probed["flops"] == whole["flops"] > 0
    names = {b["name"]: b["trips"] for b in probed["bodies"]}
    cfg = TCFG.get_reduced(arch)
    assert sum(names.values()) == cfg.n_layers + (TM._hybrid_groups(cfg)[0]
                                                  if cfg.family == "hybrid" else 0)
    for b in probed["bodies"]:
        assert ("bwd" in b) == (kind == "train")


def test_probe_window_decode():
    sh = ShapeCfg("w", 64, 1, "decode", window=16)
    for arch in ("zamba2-7b", "falcon-mamba-7b"):
        assert (DR.run_bodies(arch, sh, "single", reduced=True)["flops"]
                == DR.run_cell(arch, sh, "single", reduced=True)["flops"])


def test_dry_run_cli(tmp_path, capsys):
    DR.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "card",
             "--out", str(tmp_path)])
    res = json.loads((tmp_path / "smollm-135m_decode_32k_card.json").read_text())
    assert res["mesh"] == "card" and res["n_devices"] == 1
    assert res["memory"]["argument_bytes"] == res["memory"]["argument_bytes_total"]
    DR.main(["--arch", "zamba2-7b", "--shape", "long_500k", "--mesh", "single", "--bodies",
             "--out", str(tmp_path)])
    bodies = json.loads((tmp_path / "zamba2-7b_long_500k_single.bodies.json").read_text())
    assert [b["name"] for b in bodies["bodies"]] == ["mamba2_layer", "shared_attn"]
    DR.main(["--arch", "smollm-135m", "--shape", "long_500k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIP  smollm-135m x long_500k" in out and "collectives: none counted" in out


# ------------------------------------------------------------------ hillclimb
def test_hillclimb_variants_by_name():
    """The reference's 22 variants, read from its source (importing it sets
    XLA_FLAGS and needs ``benchmarks/``)."""
    src = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "hillclimb.py"
    node = next(n for n in ast.parse(src.read_text()).body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VARIANTS")
    assert HC.VARIANTS == ast.literal_eval(node.value) and len(HC.VARIANTS) == 22


@pytest.mark.parametrize("name", list(HC.VARIANTS))
def test_hillclimb_every_variant_on_a_reduced_cell(name):
    sh = ShapeCfg("small", 32, 2, "train")
    r = HC.measure("dbrx-132b", sh, HC.VARIANTS[name], reduced=True)
    assert r["t_compute"] == r["flops"] / 989e12 > 0
    assert r["t_memory"] == r["bytes"] / 3.35e12 > 0
    assert r["t_collective"] == 0.0 and r["colls"] is None
    assert r["bodies"]["flops"] == r["flops"]
    if not HC.effective(HC.VARIANTS[name]):
        base = HC.measure("dbrx-132b", sh, {}, reduced=True)
        assert (r["flops"], r["bytes"], r["temp_gb"]) == (base["flops"], base["bytes"],
                                                          base["temp_gb"])


def test_hillclimb_cli(tmp_path, capsys):
    HC.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--variant", "baseline",
             "--variant", "seq_shard", "--variant", "seq_shard_chunked", "--out",
             str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert "no collectives on one card" in lines[0]
    assert lines[2].startswith("seq_shard ") and "the baseline's numbers" in lines[2]
    assert lines[1].split()[1:5] == lines[2].split()[1:5]
    assert "its sharding levers inert" in lines[3]
    assert (tmp_path / "smollm-135m_decode_32k_seq_shard.json").exists()
