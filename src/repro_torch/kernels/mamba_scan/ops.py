"""Public wrapper for the selective-scan kernel."""

from repro_torch.kernels.mamba_scan.kernel import selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


def selective_scan_op(dt, a_log, b_ssm, c_ssm, x, d_skip, *, dt_bias=None, z=None,
                      backend: str = "kernel"):
    """``(y, h_S)``; with ``dt_bias`` and ``z``, the fused mode (see
    :func:`kernel.selective_scan`).  ``backend="kernel"`` goes through
    :func:`kernel.selective_scan` (the CUDA kernel on the card, its plain
    version for a CPU tensor); ``"ref"`` runs the plain version wherever the
    tensors lie."""
    if backend == "kernel":
        return selective_scan(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias=dt_bias, z=z)
    if backend == "ref":
        return selective_scan_ref(dt, a_log, b_ssm, c_ssm, x, d_skip, dt_bias=dt_bias, z=z)
    raise ValueError(f"unknown backend {backend!r}")
