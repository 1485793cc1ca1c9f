"""Public wrapper for fused RMSNorm over any leading shape."""

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_op(x, w, *, backend: str = "kernel", eps: float = 1e-6):
    """``backend="kernel"`` goes through :func:`kernel.rmsnorm` (the CUDA
    kernel on the card, its plain version for a CPU tensor); ``"ref"`` runs
    the plain version wherever ``x`` lies."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()  # a copy only for a strided view
    if backend == "kernel":
        out = rmsnorm(x2, w, eps=eps)
    elif backend == "ref":
        out = rmsnorm_ref(x2, w, eps)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return out.reshape(shape)
