"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304;
non-parametric LayerNorm.  [arXiv:2402.00838; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50304,
        norm="layernorm_np",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        norm="layernorm_np",
        remat="none",
        dtype="float32",
    )
