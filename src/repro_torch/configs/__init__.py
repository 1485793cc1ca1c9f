"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Counterpart of the JAX package's ``configs/__init__.py``: all ten of the
reference's architectures.  Each module holds the exact published
configuration and a smoke (reduced) configuration of the same family for
CPU tests.  ``launch/tuned.py`` holds the tuning the reference's launcher
applies on top (its whole table; on one card only ``moe_groups`` for the two
MoE archs changes the math); ``configs/shapes.py``
the reference's input shapes (``long_500k``: zamba2-7b and falcon-mamba-7b
only).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).config()


def get_reduced(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).reduced_config()
