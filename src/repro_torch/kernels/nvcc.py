"""Building the port's hand-written CUDA kernels with ``nvcc``.

Every source under a kernel package's ``csrc/`` is compiled on its own into
a shared library with a plain C interface, for ``sm_90a``, at first use:
``build/<group>/<source>-<hash>/lib<source>.so`` under the repository root
(the hash covers the source, its headers and the flags, so an edited source
is rebuilt).  :func:`build` starts one ``nvcc`` per library not yet built,
all together, and waits for them; the kernel modules load the results with
``ctypes``.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
# the header the three model kernels share (conversions, 16-byte vectors)
MODEL_COMMON = Path(__file__).resolve().parent / "model_common.cuh"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


class Library(NamedTuple):
    """One shared library: ``group`` names its directory under ``build/``."""

    group: str
    source: Path
    headers: Tuple[Path, ...] = ()

    @property
    def name(self) -> str:
        return self.source.stem

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for h in self.headers:
            digest.update(h.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return (BUILD_ROOT / self.group / f"{self.name}-{digest.hexdigest()[:16]}"
                / f"lib{self.name}.so")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(libraries: Iterable[Library], verbose: bool = False) -> Dict[str, Path]:
    """Compile every library not yet built, one ``nvcc`` each, all started
    together; returns each library's path by name.  ``verbose`` rebuilds
    with ``-Xptxas -v`` and prints the compiler's report of registers and
    shared memory."""
    libraries = list(libraries)
    outs = {lib.name: lib.path() for lib in libraries}
    jobs = []
    for lib in libraries:
        out = outs[lib.name]
        if out.exists() and not verbose:
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((lib.name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc {name} failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err, end="")
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def check_tensor(name: str, t, dtypes, shape, device) -> None:
    """Raise unless ``t`` lies on ``device``, has one of ``dtypes``, the
    ``shape`` given and a contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tensors(device, *specs) -> None:
    """One pass over ``(name, tensor, dtypes, shape)`` specs: raise, as
    :func:`check_tensor` words it, unless each tensor lies on ``device``,
    has one of its ``dtypes``, its ``shape`` and a contiguous layout."""
    for name, t, dtypes, shape in specs:
        if (t.device != device or t.dtype not in dtypes or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(name, t, dtypes, shape, device)


_CURRENT_RAW_STREAM = None


def stream(device) -> int:
    """The handle of the current CUDA stream of ``device`` (a
    ``torch.device`` or its index), as the C entry points take it: the
    stream that ``torch.cuda.stream(...)`` or ``torch.cuda.set_stream`` made
    current, read without building a ``torch.cuda.Stream``."""
    global _CURRENT_RAW_STREAM
    if _CURRENT_RAW_STREAM is None:
        import torch

        _CURRENT_RAW_STREAM = torch._C._cuda_getCurrentRawStream
    return _CURRENT_RAW_STREAM(device if isinstance(device, int) else device.index)
