"""The port's serving launcher on the frontend-stub archs, against the JAX
package's.

``musicgen-large`` (audio: frame embeddings in) and ``llama-3.2-vision-11b``
(vlm: image embeddings beside the tokens) have no frontend in either
package, so both launchers refuse to serve them outside ``--tier-only``,
with the same message and exit code; with ``--tier-only --reduced`` both
run the request tier alone and report the same lines (the reference run as
a subprocess, as ``tests/test_torch_serve.py`` runs it).
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.launch import serve as JV  # noqa: E402
from repro_torch.launch import serve as TV  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["musicgen-large", "llama-3.2-vision-11b"]


def _reference_exit(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as exc:
        JV.main()
    return exc.value.code


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_frontend_stub_archs(arch, monkeypatch):
    """Without ``--tier-only`` both launchers exit with the reference's
    message (``--reduced`` too); the port's as a command, exit code 1 and
    the message on stderr."""
    want = f"{arch}: frontend-stub arch — see examples/"
    for extra in ([], ["--reduced"]):
        argv = ["--arch", arch, *extra]
        assert _reference_exit(argv, monkeypatch) == want
        with pytest.raises(SystemExit) as exc:
            TV.main(argv + ["--device", "cpu"])
        assert exc.value.code == want
    env = dict(os.environ, PYTHONPATH="src")
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 1 and port.stdout == ""
    assert port.stderr.strip().splitlines()[-1] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_tier_only_matches_jax(arch):
    """``--tier-only --reduced``: the request tier alone, the reference
    launcher's lines (wall-clock times cut)."""
    argv = ["--arch", arch, "--reduced", "--tier-only", "--sessions", "12"]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = TV.serve(TV.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert out["completed"] == 12 and out["params"] is None

    def lines(text):
        return [re.sub(r" tok in \d+ ms.*", " tok", ln) for ln in text.splitlines()]

    assert lines(buf.getvalue()) == lines(ref.stdout)
    assert lines(ref.stdout)[0] == f"{arch}: served 12 sessions in 3 rounds, 0 tok"
