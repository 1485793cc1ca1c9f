"""The port's training runtime over DFC-Checkpoint, on the CPU.

The twin of ``test_checkpoint.py::test_exactly_once_resume_equals_
uninterrupted`` (the resumed run equals the uninterrupted one bit for bit);
both packages' runtimes from the same parameters, held to the same durable
layer (file list, per-tag pwb / pfence counts, manifests, the verdicts after
a crash at every other persistence op of the first two combines) and leaf
values within 1e-5; a bf16 model checkpointed and resumed, its files byte
for byte the reference manager's for the same state; and the launcher
against ``python -m repro.launch.train``, both in-process.
"""

import dataclasses
import io
import json
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.checkpoint import dfc_checkpoint as JCK  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipe  # noqa: E402
from repro.launch import train as JTRAIN  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdam  # noqa: E402
from repro.runtime.train_loop import TrainRuntime as JRuntime  # noqa: E402
from repro_torch.checkpoint import dfc_checkpoint as TCK  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.train_loop import TrainRuntime  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# ``test_checkpoint``'s tiny model with 2 / 1 heads of 16 in place of 4 / 2
# of 8 (the flash wrapper takes head dims of 16 and up), so the kernels'
# Functions run
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            d_ff=64, vocab=64, remat="none", dtype="float32")


def _port(root, injector=None, dtype="float32", ckpt_every=3, params=None):
    """The port's runtime of ``test_checkpoint._make_runtime`` (``params``:
    start from these numpy leaves, the reference's)."""
    cfg = ModelConfig(**dict(TINY, dtype=dtype))
    fs = TCK.SimFS(root, injector)
    pipe = DataPipeline(vocab=64, batch_size=2, seq_len=8, seed=3)
    rt = TrainRuntime(cfg, AdamWConfig(lr=1e-3), pipe, fs, n_workers=2, ckpt_every=ckpt_every,
                      device="cpu")
    if params is not None:
        def fresh():
            p = params_from_numpy(params, cfg, "cpu")
            return p, init_opt_state(p, rt.opt_cfg)
        rt._fresh_state = fresh
    return rt


_JAX_STEP = {}


def _ref(root, injector=None, ckpt_every=3):
    """The reference's runtime, its jitted step shared across instances (the
    same configuration), so a sweep compiles it once."""
    fs = JCK.SimFS(root, injector)
    pipe = JPipe(vocab=64, batch_size=2, seq_len=8, seed=3)
    rt = JRuntime(JConfig(**TINY), JAdam(lr=1e-3), pipe, fs, n_workers=2,
                  ckpt_every=ckpt_every)
    rt._step_fn = _JAX_STEP.setdefault("step", rt._step_fn)
    return rt


def _ref_params():
    return jax.device_get(JM.init_params(JConfig(**TINY), jax.random.PRNGKey(0)))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _manifest(fs):
    epoch = int(fs.read_durable("cEpoch").decode())
    epoch += epoch % 2  # the second increment is published, not persisted
    slot = f"top/slot{(epoch // 2) % 2}"
    return json.loads(fs.read_durable(f"{slot}/manifest.json").decode())


def test_exactly_once_resume_equals_uninterrupted(tmp_path):
    """Crash mid-training; the resumed run reproduces the uninterrupted run
    bit for bit (exactly-once step semantics)."""
    p_ref, o_ref, _ = _port(tmp_path / "ref").train(10)

    # 54 persistence ops a checkpoint (10 announcing, 44 combining 37
    # leaves): op 80 lies inside the second combine
    rt = _port(tmp_path / "crash", TCK.FaultInjector(crash_at=80))
    with pytest.raises(TCK.CrashNow):
        rt.train(10)
    rt2 = _port(tmp_path / "crash")  # a fresh post-crash view of the durable files
    params, opt, step, cursor, report = rt2.boot()
    # the step-6 announcements died with the crash: a definite LOST verdict
    assert step == cursor == 3
    assert all(r == {"committed": False, "step": 6} for r in report.values())
    p2, o2, _ = rt2.train(10)
    for a, b in zip(tree_flatten((p_ref, o_ref)), tree_flatten((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_durable_layer_equals_the_reference(tmp_path):
    """From the same parameters: the same files, per-tag counts and manifest
    (meta, shapes, dtypes), the leaves within 1e-5."""
    params = _ref_params()
    jrt, trt = _ref(tmp_path / "jax"), _port(tmp_path / "port", params=params)
    jp, jo, jl = jrt.train(6)
    tp, to, tl = trt.train(6)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert trt.fs.stats == jrt.fs.stats
    assert (trt.fs.pstats.pwb, trt.fs.pstats.pfence) == (jrt.fs.pstats.pwb, jrt.fs.pstats.pfence)
    tman, jman = _manifest(trt.fs), _manifest(jrt.fs)
    assert tman["meta"] == jman["meta"] == {"step": 6, "cursor": 6}
    assert tman["epoch"] == jman["epoch"]
    assert [(e["file"], e["shape"], e["dtype"]) for e in tman["leaves"]] == [
        (e["file"], e["shape"], e["dtype"]) for e in jman["leaves"]]
    tleaves, _ = trt.mgr.load_active()
    jleaves, _ = jrt.mgr.load_active()
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for a, b in zip(tree_flatten((tp, to)), jax.tree_util.tree_leaves((jp, jo))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_crash_verdicts_equal_the_reference(tmp_path):
    """A crash at every other persistence op of the first two combines
    (ckpt_every 1, two steps), then boot on the durable view: the same
    verdicts, committed step and cursor, files and counts in both."""
    params = _ref_params()
    probe = _port(tmp_path / "probe", ckpt_every=1, params=params)
    probe.train(2)
    total = probe.fs.stats["pwb"] + probe.fs.stats["pfence"]
    assert total > 80
    for k in range(1, total + 1, 2):
        roots = {side: tmp_path / f"k{k}" / side for side in ("jax", "port")}
        jrt = _ref(roots["jax"], JCK.FaultInjector(crash_at=k), ckpt_every=1)
        trt = _port(roots["port"], TCK.FaultInjector(crash_at=k), ckpt_every=1, params=params)
        with pytest.raises(JCK.CrashNow):
            jrt.train(2)
        with pytest.raises(TCK.CrashNow):
            trt.train(2)
        jb = _ref(roots["jax"], ckpt_every=1).boot()
        tb = _port(roots["port"], ckpt_every=1, params=params).boot()
        assert tb[2:] == jb[2:], k  # step, cursor, the detectability report
        assert _files(roots["port"]) == _files(roots["jax"]), k


def test_bf16_checkpoint_resumes_with_the_reference_bytes(tmp_path):
    """A bf16 model: each leaf file is the reference manager's ``np.save``
    of the same bits (``'descr': '<V2'``, manifest ``"bfloat16"``), and the
    resume reads the bits back."""
    rt = _port(tmp_path / "port", dtype="bfloat16", ckpt_every=2)
    p, o, _ = rt.train(2)
    leaves = tree_flatten((p, o))
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    # the reference's manager combining the same state (the same bits, as JAX holds them)
    jfs = JCK.SimFS(tmp_path / "jax")
    jmgr = JCK.DFCCheckpointManager(jfs, 2)
    for w in range(2):
        jmgr.announce(w, {"step": 2, "cursor": 2})
    jtree = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
             else jnp.asarray(t.numpy()) for t in leaves]
    jmgr.combine(jtree, extra_meta={"step": 2, "cursor": 2})
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for rel in _files(tmp_path / "jax"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    man = _manifest(rt.fs)
    assert {e["dtype"] for e in man["leaves"]} == {"bfloat16", "float32", "int32"}
    data = next((tmp_path / "port").glob("top/slot*/leaf_0.npy")).read_bytes()
    assert b"'descr': '<V2'" in data
    _, _, step, cursor, _ = rt.boot()
    back = _port(tmp_path / "port", dtype="bfloat16", ckpt_every=2).boot()
    assert back[2:4] == (step, cursor) == (2, 2)
    for a, b in zip(leaves, tree_flatten(back[:2])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and training on from the resumed state runs
    _, _, more = _port(tmp_path / "port", dtype="bfloat16", ckpt_every=2).train(3)
    assert len(more) == 1 and np.isfinite(more[0])


def _run(main, argv, monkeypatch, as_argv=False):
    out = io.StringIO()
    with redirect_stdout(out):
        if as_argv:
            monkeypatch.setattr(sys, "argv", ["train"] + argv)
            main()
        else:
            main(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "zamba2-7b", "dbrx-132b",
                                  "qwen2-1.5b", "olmo-1b", "deepseek-coder-33b"])
def test_launcher_matches_the_reference(arch, tmp_path, monkeypatch):
    flags = ["--arch", arch, "--reduced", "--steps", "6", "--ckpt-every", "3",
             "--workers", "2"]
    cfg = JCFG.get_reduced(arch)
    params = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))

    def fresh(self):
        p = params_from_numpy(params, self.cfg, self.device)
        return p, init_opt_state(p, self.opt_cfg)

    monkeypatch.setattr(TrainRuntime, "_fresh_state", fresh)
    want = _run(JTRAIN.main, flags + ["--ckpt-dir", str(tmp_path / "jax")], monkeypatch, True)
    got = _run(TTRAIN.main, flags + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"],
               monkeypatch)
    assert len(got) == len(want) == 2
    assert got[1] == want[1] and got[1].startswith("persistence: ")
    nums = lambda line: [float(x) for x in re.findall(r"-?\d+\.\d+", line)]
    assert got[0].split(":")[0] == want[0].split(":")[0] == "trained to step 6"
    np.testing.assert_allclose(nums(got[0]), nums(want[0]), atol=1e-3, rtol=0)
    # resumed: both print the committed step and its verdicts
    want = _run(JTRAIN.main, flags[:4] + ["8"] + flags[5:] + ["--ckpt-dir",
                                                              str(tmp_path / "jax")],
                monkeypatch, True)
    got = _run(TTRAIN.main, flags[:4] + ["8"] + flags[5:] + [
        "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"], monkeypatch)
    assert got[0] == want[0] and got[0].startswith("resuming from committed step 6")
    assert got[2] == want[2]


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
def test_launcher_refuses_frontend_stubs(arch, tmp_path):
    with pytest.raises(SystemExit, match="frontend-stub"):
        TTRAIN.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])


def test_launcher_takes_ssm_on_either_device(tmp_path):
    """The ssm family, once refused on the card, is refused on neither
    device: ``--device cpu`` builds its runtime, and the default device
    without a card fails where any family's would, in ``resolve_device``."""
    args = TTRAIN.parse_args(["--arch", "falcon-mamba-7b", "--reduced", "--ckpt-dir",
                              str(tmp_path)])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TTRAIN.build(args)
    args.device = "cpu"
    cfg, _, rt = TTRAIN.build(args)
    assert cfg.family == "ssm" and rt.device == torch.device("cpu")
