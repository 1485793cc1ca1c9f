"""The port's launch surfaces of per-side lanes and resharding against the
JAX package's, on the CPU: ``serve_shards --split-backlog`` against
``examples/serve_shards.py``, and the serving launcher's ``--split-lanes`` /
``--reshard-backlog`` against ``python -m repro.launch.serve``.  The
reference runs in this process (its report captured from stdout); wall-clock
numbers are cut from both reports.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import serve as JV  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402
from repro_torch.launch import serve_shards  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]


def _cut(text):
    """Report lines without wall-clock numbers, the device and model lines."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"throughput: .*", "throughput", line)
        line = re.sub(r" tok in \d+ ms.*", " tok", line)
        line = re.sub(r" device=\w+", "", line)
        if not line.startswith("model:"):
            out.append(line)
    return out


def _reference(main, argv, monkeypatch):
    """A reference entry point that parses ``sys.argv``, run in-process."""
    monkeypatch.setattr(sys, "argv", ["reference", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    return _cut(buf.getvalue())


def _example_main():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_shards", REPO / "examples" / "serve_shards.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("depth", ["1", "3"])
def test_serve_shards_split_backlog_matches_example(depth, monkeypatch):
    """``--split-backlog``: the same split lines, shard count, load and
    pwb/op / pfence/op as ``examples/serve_shards.py`` (on a smaller fabric
    than the example's 16 x 256 x 50, which the card runs)."""
    argv = ["--mixed", "--durable", "--shards", "8", "--batch", "64", "--phases", "8",
            "--threads", "4", "--split-backlog", "16", "--depth", depth]
    want = _reference(_example_main(), argv, monkeypatch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_shards.serve(serve_shards.build_parser().parse_args(
            argv + ["--device", "cpu"]))
    got = _cut(buf.getvalue())
    assert got == want and out["splits"]
    assert sum(line.startswith("split: phase") for line in got) == len(out["splits"])
    assert out["rt"].n_shards == 8 + len(out["splits"])


@pytest.mark.parametrize("flags", [["--split-lanes"], ["--reshard-backlog", "4"],
                                   ["--split-lanes", "--reshard-backlog", "4"]],
                         ids=["lanes", "reshard", "both"])
def test_launcher_lane_and_reshard_lines_match_jax(flags, monkeypatch):
    """The launcher's report at the durable priority tier's flags: the same
    ``splits=``, ``split lanes:`` and pwb/op / pfence/op lines."""
    argv = ["--arch", "smollm-135m", "--batch", "8", "--prompt-len", "512", "--gen", "32",
            "--sessions", "16", "--durable", "--priority", "--high-every", "3", "--tier-only",
            *flags]
    want = _reference(JV.main, argv, monkeypatch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TV.main(argv + ["--device", "cpu"])
    got = _cut(buf.getvalue())
    assert got == want
    tier_line = next(line for line in got if line.startswith("request tier:"))
    assert ("splits=1" in tier_line) == ("--reshard-backlog" in flags)
    assert any(line.startswith("split lanes:") for line in got) == ("--split-lanes" in flags)
