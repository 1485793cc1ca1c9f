"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Counterpart of the JAX package's ``configs/__init__.py`` for the ported
architectures.  Each module holds the exact published configuration and a
smoke (reduced) configuration of the same family for CPU tests.  The other
eight architectures of the reference wait for their families' slices (see
``ROADMAP.md``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).config()


def get_reduced(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).reduced_config()
