"""The simulated NVM and its node pool (counterpart of the JAX package's ``nvm``)."""

from repro_torch.nvm.memory import CrashMode, NVMemory, PersistStats
from repro_torch.nvm.pool import NodePool

__all__ = ["NVMemory", "PersistStats", "CrashMode", "NodePool"]
