"""The model kernels on the ``meta`` device: what the dry run
(``launch/dryrun.py``) sees of a call.

A kernel wrapper given ``meta`` tensors takes its kernel's path up to the
launch: it checks its arguments and allocates its outputs and scratch
buffers as on the card (so a tracker of live bytes sees the kernel's
memory, not the plain version's intermediates), launches nothing, counts no
launch, and reports the call here: its name, the matrix-product FLOPs of
the function it computes (2 a multiply-add; the flash kernels' products at
the true head dim, not at the width a head dim is padded to on the card;
the others none) and the bytes it must move (each input read once, each
output written once).
:func:`account` routes the reports to a sink for the length of a ``with``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

Sink = Callable[[str, int, int], None]
_SINKS: List[Sink] = []


@contextlib.contextmanager
def account(sink: Sink):
    """Call ``sink(name, flops, nbytes)`` for each kernel call on ``meta``
    tensors made inside the block."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def note(name: str, flops: int, *tensors) -> None:
    """Report one kernel call on ``meta`` tensors: ``flops`` and the bytes of
    ``tensors`` (its inputs and outputs; None is skipped)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    for sink in _SINKS:
        sink(name, flops, nbytes)


def attention_pairs(s: int, t: int, causal: bool) -> int:
    """(query, key) pairs an attention over S queries at positions 0..S-1
    and T keys reads: S x T, or with ``causal`` each query's keys up to its
    own position."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t
