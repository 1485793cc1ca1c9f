"""The port's quickstart against the reference's, each in a process of its
own: ``python -m repro_torch.launch.quickstart --device cpu`` prints the
lines of ``examples/quickstart.py`` on the CPU, but for part 2's header,
which names the card's combine instead of the TPU's; without ``--device``
it runs on the card and, where there is none, fails before printing."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")


def _run(*argv):
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True, env=ENV,
                          cwd=REPO, timeout=300)


def test_port_quickstart_prints_the_references_lines():
    ref = _run("examples/quickstart.py")
    port = _run("-m", "repro_torch.launch.quickstart", "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    want, got = ref.stdout.splitlines(), port.stdout.splitlines()
    header = want.index("== 2. TPU-native vectorized combine ==")
    assert got[header] == "== 2. CUDA-native vectorized combine =="
    assert got[:header] + got[header + 1:] == want[:header] + want[header + 1:]
    assert len(got) == 13 and got[-1] == "done."


def test_port_quickstart_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = _run("-m", "repro_torch.launch.quickstart")
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


def test_quickstart_combine_is_the_vectorized_combine():
    """Part 2's one-object step equals the vectorized combine of
    ``core/torch_dfc.py`` (the twin of the reference's ``combine``) bit for
    bit on the CPU."""
    import torch
    from repro_torch.core import torch_dfc as T
    from repro_torch.launch import quickstart as Q

    out = Q.vectorized(torch.device("cpu"))
    state, resp, kinds = T.combine(T.init_stack(64, device="cpu"), out["ops"], out["params"])
    assert torch.equal(resp.view(torch.int32), out["resp"].view(torch.int32))
    assert torch.equal(kinds, out["kinds"])
    for a, b in zip(state.leaves(), out["state"].leaves()):
        assert torch.equal(a, b)
