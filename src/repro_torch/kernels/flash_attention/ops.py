"""Public wrapper: backend-selected attention (CUDA kernel or plain version).

The reference's ``chunked_attention`` (an online softmax over key chunks in
XLA, for its dry-run path) is on no path of the port yet: no configuration
sets ``attn_impl="chunked"``.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal=True, backend: str = "kernel"):
    """``backend="kernel"`` goes through :func:`kernel.flash_attention` (the
    CUDA kernel on the card, its plain version for a CPU tensor); ``"ref"``
    runs the plain version wherever the tensors lie."""
    if backend == "kernel":
        return flash_attention(q, k, v, causal=causal)
    if backend == "ref":
        return attention_ref(q, k, v, causal=causal)
    raise ValueError(f"unknown backend {backend!r}")
